"""CSV experiment logs for sweeps.

Port of ``cnn_quantization_tpu/utils/eval_log.py`` (reference
utils/log.py:241-266, ``EvalLog``): an append-and-save table used by the
precision and layer-sensitivity sweeps.  The standard library's ``csv``
writes the file the JAX package's pandas writes (a header, one line a row,
no index).
"""

from __future__ import annotations

import csv
import os


class EvalLog:
    def __init__(self, columns, path: str | None = None, auto_save: bool = False):
        self.columns = list(columns)
        self.rows: list[list] = []
        self.path = path
        self.auto_save = auto_save

    def log(self, *values):
        if len(values) != len(self.columns):
            raise ValueError(f'{len(values)} values for columns {self.columns}')
        self.rows.append(list(values))
        if self.auto_save and self.path:
            self.save(self.path)

    def save(self, path: str | None = None):
        path = path or self.path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, 'w', newline='') as f:
                w = csv.writer(f, lineterminator='\n')
                w.writerow(self.columns)
                w.writerows(self.rows)

    def __str__(self):
        table = [self.columns] + [[str(v) for v in r] for r in self.rows]
        widths = [max(len(str(r[i])) for r in table) for i in range(len(self.columns))]
        return '\n'.join('  '.join(str(v).rjust(w) for v, w in zip(r, widths)) for r in table)
