"""ResultsLog: row-oriented experiment results with CSV/JSON persistence and
an optional plot.

Port of ``cnn_quantization_tpu/utils/results_log.py`` (reference
utils/log.py:67-229, pandas + bokeh).  The standard library writes the CSV
and the JSON records the JAX package's pandas writes (columns in first-seen
order, a missing value empty in the CSV and null in the JSON); matplotlib is
imported only inside ``plot``, which does nothing where it is absent.
"""

from __future__ import annotations

import csv
import json
import os


def _parse(v: str):
    """A CSV field as pandas' ``read_csv`` infers it: int, float, or the string."""
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


class ResultsLog:
    def __init__(self, path: str, title: str = ''):
        self.path = path
        self.title = title
        self.rows: list[dict] = []

    @property
    def columns(self) -> list[str]:
        cols: list[str] = []
        for r in self.rows:
            cols += [k for k in r if k not in cols]
        return cols

    def add(self, **kwargs):
        self.rows.append(dict(kwargs))

    def save(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        cols = self.columns
        with open(self.path + '.csv', 'w', newline='') as f:
            w = csv.writer(f, lineterminator='\n')
            w.writerow(cols)
            w.writerows([r.get(c, '') for c in cols] for r in self.rows)
        with open(self.path + '.json', 'w') as f:
            json.dump([{c: r.get(c) for c in cols} for r in self.rows], f, separators=(',', ':'))

    def load(self):
        if os.path.exists(self.path + '.csv'):
            with open(self.path + '.csv', newline='') as f:
                self.rows = [{k: _parse(v) for k, v in r.items() if v != ''}
                             for r in csv.DictReader(f)]
        return self

    def plot(self, x: str, y, title: str | None = None) -> str | None:
        """A PNG of columns ``y`` against ``x`` at ``<path>_<x>.png``; None
        where matplotlib is not installed."""
        try:
            import matplotlib
        except ImportError:
            return None
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        ys = [y] if isinstance(y, str) else list(y)
        fig, ax = plt.subplots()
        try:
            for col in ys:
                ax.plot([r.get(x) for r in self.rows], [r.get(col) for r in self.rows],
                        marker='o', label=col)
            ax.set_xlabel(x)
            ax.legend()
            ax.set_title(title or self.title)
            out = self.path + f'_{x}.png'
            fig.savefig(out, dpi=110)
        finally:
            plt.close(fig)
        return out

    def __str__(self):
        cols = self.columns
        return '\n'.join(['\t'.join(cols)] +
                         ['\t'.join(str(r.get(c, '')) for c in cols) for r in self.rows])
