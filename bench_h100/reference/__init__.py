"""The plain reference that decides a run's `correct`; imports nothing of
the program."""
