"""Evaluation tables without pandas.

Port of pulpo_tpu/eval/tables.py (the reference's make_tables,
convert_to_scientific and table_jdet, evaluate.py:531-602). The card's
machine has no pandas, so a `Table` holds what the JAX package's
DataFrame holds: a row index, columns as (set, metric) pairs and
float64 values, rounded to 3 decimals where the JAX code rounds.
`make_tables` writes `<name>.csv` and `<name>.tex`, and where matplotlib
is installed `<name>.svg`, the JAX package's matplotlib table with the
same cells; where it is not (the card's machine) nothing more, as
`visualize.draw`'s figures.
"""

from __future__ import annotations

import csv
import importlib.util
import math
import os
from typing import Sequence

import numpy as np
import torch


class Table:
    """A 2-D float64 table with (set, metric) column pairs."""

    def __init__(self, values, columns: Sequence[tuple[str, str]], index=None,
                 index_name: str | None = None):
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != 2 or self.values.shape[1] != len(columns):
            raise ValueError(f"values {self.values.shape} do not fit {len(columns)} columns")
        self.columns = [tuple(str(p) for p in c) for c in columns]
        self.index = list(range(self.values.shape[0]) if index is None else index)
        self.index_name = index_name

    @classmethod
    def from_sets(cls, values, sets: Sequence[str], metrics: Sequence[str], index=None):
        """Columns ordered set-major: (set_0, metric_0), (set_0, metric_1), ..."""
        columns = [(s, m) for s in sets for m in metrics]
        return cls(values, columns, index=index)

    @property
    def shape(self) -> tuple[int, int]:
        return self.values.shape

    def __getitem__(self, column: tuple[str, str]) -> np.ndarray:
        return self.values[:, self.columns.index(tuple(column))]

    def __contains__(self, column) -> bool:
        return tuple(column) in self.columns

    def round(self, decimals: int) -> "Table":
        return Table(np.round(self.values, decimals), self.columns, self.index,
                     self.index_name)

    def cells(self) -> list[list[str]]:
        return [[_fmt(v) for v in row] for row in self.values]

    def __str__(self) -> str:
        head = [[self.index_name or ""] + [c[0] for c in self.columns],
                [""] + [c[1] for c in self.columns]]
        rows = head + [[str(i)] + r for i, r in zip(self.index, self.cells())]
        widths = [max(len(r[j]) for r in rows) for j in range(len(rows[0]))]
        return "\n".join("  ".join(c.rjust(w) for c, w in zip(r, widths)) for r in rows)

    def to_csv(self, path) -> None:
        """Two header rows (set, metric), then one row per index entry."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([self.index_name or ""] + [c[0] for c in self.columns])
            w.writerow([""] + [c[1] for c in self.columns])
            for i, row in zip(self.index, self.values):
                w.writerow([i] + [repr(float(v)) for v in row])

    def to_latex(self) -> str:
        """A tabular with the sets as multicolumn heads over their metrics."""
        groups: list[list] = []
        for s, _ in self.columns:
            if groups and groups[-1][0] == s:
                groups[-1][1] += 1
            else:
                groups.append([s, 1])
        lines = [r"\begin{tabular}{l" + "r" * len(self.columns) + "}"]
        lines.append(" & " + " & ".join(
            rf"\multicolumn{{{n}}}{{r}}{{{_tex(s)}}}" for s, n in groups) + r" \\")
        lines.append((_tex(self.index_name or "")) + " & "
                     + " & ".join(_tex(m) for _, m in self.columns) + r" \\")
        for i, row in zip(self.index, self.cells()):
            lines.append(f"{_tex(str(i))} & " + " & ".join(row) + r" \\")
        lines.append(r"\end{tabular}")
        return "\n".join(lines) + "\n"


def _tex(s: str) -> str:
    return s.replace("_", r"\_").replace("%", r"\%")


def convert_to_scientific(value):
    if isinstance(value, (int, float)) and 0.0 < abs(value) < 0.001:
        return format(value, ".2e")
    return value


def _fmt(v: float) -> str:
    v = convert_to_scientific(float(v))
    if isinstance(v, str):
        return v
    return "nan" if math.isnan(v) else f"{v:.6f}"


def make_tables(table: Table, output_dir, name: str | None = None,
                show: bool = False) -> str:
    """Write <name>.csv, <name>.tex and, where matplotlib is installed,
    <name>.svg (`_draw_svg`); returns the LaTeX."""
    latex = table.to_latex()
    if show:
        print(latex)
    if name is not None:
        os.makedirs(output_dir, exist_ok=True)
        table.to_csv(os.path.join(output_dir, f"{name}.csv"))
        with open(os.path.join(output_dir, f"{name}.tex"), "w") as f:
            f.write(latex)
        if importlib.util.find_spec("matplotlib") is not None:
            _draw_svg(table, os.path.join(output_dir, f"{name}.svg"))
    return latex


def _draw_svg(table: Table, path) -> None:
    """The JAX `make_tables`' matplotlib table (pulpo_tpu/eval/tables.py:
    21-50), saved to `path`: each cell as the JAX package's DataFrame
    shows it (`convert_to_scientific`, then `str`), the (set, metric)
    columns and the index as their `str`. Imports matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    fig.patch.set_visible(False)
    ax.axis("off")
    cells = [[str(convert_to_scientific(float(v))) for v in row] for row in table.values]
    drawn = ax.table(cellText=cells, colLabels=[str(c) for c in table.columns],
                     rowLabels=[str(i) for i in table.index], loc="center")
    drawn.auto_set_font_size(False)
    drawn.set_fontsize(4)
    drawn.auto_set_column_width(col=list(range(len(table.columns))))
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def multiindex_table(mean_metrics: np.ndarray, loader_names: Sequence[str],
                     metric_names: Sequence[str], index) -> Table:
    """(metrics, rows, datasets) nanmean data -> a (set, metric) column
    table with one row per `index` entry, rounded to 3 decimals
    (evaluate.py:1483-1490; the JAX package's MultiIndex DataFrame)."""
    data = np.asarray(mean_metrics).T
    data = np.concatenate(data, axis=1) if data.ndim == 3 else data
    return Table.from_sets(data, loader_names, metric_names, index=list(index)).round(3)


def table_jdet(final_dfs: dict, individual_dfs: dict, output_dir=None, name: str = "",
               save: bool = False) -> Table:
    """JDet std and % <= 0 for the combined (final) and individual dfs of
    each level (evaluate.py:569-602). dfs are channels-last (B, *spatial, nd)."""
    from pulpo_tpu_torch.eval.metrics import jdet_leq0_percent
    from pulpo_tpu_torch.ops.losses import jacobian_det

    def jdet(df):
        df = df if torch.is_tensor(df) else torch.from_numpy(np.asarray(df))
        with torch.inference_mode():
            return jacobian_det(df.float()).cpu().numpy()

    latent_levels = len(final_dfs)
    data = np.zeros((latent_levels, 4))
    for l in reversed(range(latent_levels)):
        jd = jdet(final_dfs[l])
        data[l, 0] = jd.std(ddof=1)
        data[l, 1] = jdet_leq0_percent(jd)
        jd = jdet(individual_dfs[l])
        data[l, 2] = jd.std(ddof=1)
        data[l, 3] = jdet_leq0_percent(jd)
    columns = [(s, m) for s in ("combined DF", "individual DF")
               for m in ("JDet std", "% of pixels <= 0")]
    table = Table(data, columns, index_name="Level").round(3)
    if save and output_dir is not None:
        make_tables(table, output_dir, name="jdet_" + name)
    return table
