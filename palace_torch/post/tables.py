"""CSV measurement tables in the reference output format.

Format rules (reference: palace/utils/tablecsv.{hpp,cpp}): right-aligned
columns, width = max(min_left_padding + precision + 7, len(header)),
defaults pad=8 prec=12 sign='+'; the leading index column uses pad=0
prec=2 and no sign.  Column separator ',', row separator '\\n'.

Copied from palace_tpu/post/tables.py, imports pointed at palace_torch;
`Table.write` writes on rank 0 only (a multi-rank run writes its files
once).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

from palace_torch import parallel


@dataclass
class Column:
    name: str
    header: str
    min_left_padding: int = 8
    precision: int = 12
    sign: str = "+"
    print_as_int: bool = False
    data: List[float] = field(default_factory=list)

    def width(self) -> int:
        if self.print_as_int:
            return max(self.min_left_padding, len(self.header))
        return max(self.min_left_padding + self.precision + 7, len(self.header))

    def fmt_header(self) -> str:
        return f"{self.header:>{self.width()}s}"

    def fmt_value(self, i: int) -> str:
        w = self.width()
        if i >= len(self.data):
            return f"{'NULL':>{w}s}"
        v = self.data[i]
        if self.print_as_int:
            return f"{int(v):>{w}d}"
        return f"{v:>{self.sign}{w}.{self.precision}e}"


def index_column(header: str = "i") -> Column:
    return Column("i", header, min_left_padding=0, precision=2, sign="")


class Table:
    def __init__(self):
        self.cols: List[Column] = []

    def add(self, col: Column) -> Column:
        self.cols.append(col)
        return col

    def col(self, name: str) -> Column:
        for c in self.cols:
            if c.name == name:
                return c
        raise KeyError(name)

    def n_rows(self) -> int:
        return max((len(c.data) for c in self.cols), default=0)

    def to_string(self) -> str:
        lines = [",".join(c.fmt_header() for c in self.cols)]
        for i in range(self.n_rows()):
            lines.append(",".join(c.fmt_value(i) for c in self.cols))
        return "\n".join(lines) + "\n"

    def write(self, path: str):
        if not parallel.is_root():  # only rank 0 writes files
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_string())
