"""Analytic validation cases of the port."""
