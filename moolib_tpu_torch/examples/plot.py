"""Plot training curves from TSV logs.

Counterpart of the reference's gnuplot-backed ``examples/plot.py``: reads the
TSV files written by :class:`moolib_tpu_torch.examples.common.TsvLogger`, plots
``--ykey`` against ``--xkey`` with optional windowed smoothing, via
matplotlib when available and an ASCII chart otherwise (the reference's
terminal-plot workflow).

Run: ``python -m moolib_tpu_torch.examples.plot logs.tsv --ykey mean_episode_return``
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple


def read_tsv(path: str, xkey: str, ykey: str) -> Tuple[List[float], List[float]]:
    xs, ys = [], []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        if xkey not in header or ykey not in header:
            raise SystemExit(f"columns {header}; need {xkey!r} and {ykey!r}")
        xi, yi = header.index(xkey), header.index(ykey)
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(xi, yi):
                continue
            try:
                x, y = float(parts[xi]), float(parts[yi])
            except ValueError:
                continue
            xs.append(x)
            ys.append(y)
    return xs, ys


def smooth(xs, ys, window: int):
    if window <= 1 or not ys:
        return xs, ys
    out_x, out_y = [], []
    acc = 0.0
    from collections import deque

    q: deque = deque()
    for x, y in zip(xs, ys):
        q.append(y)
        acc += y
        if len(q) > window:
            acc -= q.popleft()
        out_x.append(x)
        out_y.append(acc / len(q))
    return out_x, out_y


def ascii_plot(xs, ys, width=70, height=20, title=""):
    if not ys:
        print("(no data)")
        return
    xmin, xmax = min(xs), max(xs)
    ymin, ymax = min(ys), max(ys)
    if ymax == ymin:
        ymax = ymin + 1
    grid = [[" "] * width for _ in range(height)]
    for x, y in zip(xs, ys):
        cx = int((x - xmin) / max(xmax - xmin, 1e-9) * (width - 1))
        cy = int((y - ymin) / (ymax - ymin) * (height - 1))
        grid[height - 1 - cy][cx] = "A"
    print(f"{title:^{width + 10}}")
    for i, row in enumerate(grid):
        yval = ymax - (ymax - ymin) * i / (height - 1)
        print(f"{yval:9.1f} |{''.join(row)}")
    print(" " * 10 + "+" + "-" * width)
    print(f"{'':10}{xmin:<12.0f}{'':^{max(width - 24, 0)}}{xmax:>12.0f}")


def main(argv=None):
    p = argparse.ArgumentParser(description="moolib_tpu_torch TSV plotter")
    p.add_argument("files", nargs="+")
    p.add_argument("--xkey", default="step")
    p.add_argument("--ykey", default="mean_episode_return")
    p.add_argument("--window", type=int, default=1)
    p.add_argument("--ascii", action="store_true", help="force terminal plot")
    p.add_argument("--out", default=None, help="save a PNG instead of showing")
    args = p.parse_args(argv)

    series = []
    for path in args.files:
        xs, ys = read_tsv(path, args.xkey, args.ykey)
        series.append((path, *smooth(xs, ys, args.window)))

    use_matplotlib = not args.ascii
    if use_matplotlib:
        try:
            import matplotlib

            matplotlib.use("Agg" if args.out else matplotlib.get_backend())
            import matplotlib.pyplot as plt
        except ImportError:
            use_matplotlib = False
    if use_matplotlib:
        for path, xs, ys in series:
            plt.plot(xs, ys, label=path)
        plt.xlabel(args.xkey)
        plt.ylabel(args.ykey)
        plt.legend()
        plt.grid(alpha=0.3)
        if args.out:
            plt.savefig(args.out, dpi=120, bbox_inches="tight")
            print(f"saved {args.out}")
        else:
            plt.show()
    else:
        for path, xs, ys in series:
            ascii_plot(xs, ys, title=f"{args.ykey} — {path}")


if __name__ == "__main__":
    main()
