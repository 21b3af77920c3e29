"""Smoke tests for the port's example tooling (the port of
``tests/test_examples_tools.py``): launcher script generation and TSV
plotting (reference counterparts: ``examples/sbatch_experiment.py``,
``examples/plot.py``), and ``utils.batchsize``'s search."""

import numpy as np

from moolib_tpu_torch.examples import launch, plot


def test_sbatch_generation(capsys):
    launch.main(["sbatch", "--num_peers", "3", "--job_name", "jt", "--",
                 "python", "-m", "moolib_tpu_torch.examples.vtrace.experiment"])
    out = capsys.readouterr().out
    assert "#SBATCH --job-name=jt" in out
    assert "#SBATCH --ntasks=4" in out  # peers + broker
    assert "moolib_tpu_torch.broker" in out
    assert "moolib_tpu_torch.examples.vtrace.experiment" in out
    assert "--connect" in out


def test_pod_generation(capsys):
    launch.main(["pod", "--broker_port", "5000"])
    out = capsys.readouterr().out
    assert "moolib_tpu_torch.broker" in out and ":5000" in out
    assert "--coordinator tcp://$HOST0:8476 --num_processes $N --process_id $i" in out


def test_tsv_logger(tmp_path):
    from moolib_tpu_torch.examples.common import TsvLogger

    path = str(tmp_path / "run1" / "logs.tsv")
    logger = TsvLogger(path, metadata={"run": "t"})
    logger.log(step=1, ret=0.5)
    logger.log(step=2, ret=1.5)
    lines = open(path).read().splitlines()
    assert lines[0].split("\t") == ["time", "step", "ret"]
    assert len(lines) == 3
    import json
    import os

    meta = json.load(open(os.path.join(os.path.dirname(path), "metadata.json")))
    assert meta["run"] == "t" and "argv" in meta
    assert os.path.islink(os.path.join(os.path.dirname(path), "latest.tsv"))
    # Round trip through the plotter.
    xs, ys = plot.read_tsv(path, "step", "ret")
    assert xs == [1.0, 2.0] and ys == [0.5, 1.5]


def test_plot_tsv_roundtrip(tmp_path, capsys):
    path = tmp_path / "logs.tsv"
    rows = ["step\treturn"]
    for i in range(50):
        rows.append(f"{i * 100}\t{i * 2.0 + np.sin(i)}")
    path.write_text("\n".join(rows) + "\n")
    xs, ys = plot.read_tsv(str(path), "step", "return")
    assert len(xs) == 50 and xs[0] == 0 and xs[-1] == 4900
    sx, sy = plot.smooth(xs, ys, window=5)
    assert len(sx) == len(sy) > 0
    plot.ascii_plot(xs, ys, title="returns")  # prints the chart
    art = capsys.readouterr().out
    assert "returns" in art and len(art.splitlines()) > 5
    # CLI end-to-end (ASCII mode prints the chart).
    plot.main([str(path), "--xkey", "step", "--ykey", "return", "--ascii"])
    out = capsys.readouterr().out
    assert "return" in out


def test_batch_size_finder():
    import torch

    from moolib_tpu_torch.utils.batchsize import find_batch_size

    def fn(x):
        return torch.tanh(x @ x.T).sum()

    def make_batch(n):
        return (torch.ones((n, 16)),)

    best = find_batch_size(make_batch, fn, start=4, max_batch=64)
    assert 4 <= best <= 64


def test_batch_size_finder_stops_on_out_of_memory(monkeypatch):
    """The search stops at the first size the card cannot hold, empties the
    allocator's cache, and answers the best size timed before it; the first
    call at each size is a warm-up that the timing leaves out."""
    import torch

    from moolib_tpu_torch.utils import batchsize

    calls, emptied = [], []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(True))

    def fn(x):
        calls.append(x.shape[0])
        if x.shape[0] > 16:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return x.sum()

    best = batchsize.find_batch_size(lambda n: (torch.ones(n, 4),), fn, start=4,
                                     max_batch=1024, threshold=0.0, iters=2)
    assert best == 16 and emptied == [True]
    assert calls == [4, 4, 4, 8, 8, 8, 16, 16, 16, 32]
