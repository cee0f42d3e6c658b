"""Port vs reference: ``utils.profiling`` and ``utils.roofline``.

``Meter`` against the JAX ``Meter`` on the same additions (the same
report, key for key); ``timed`` on the CPU (the host clock, the median of
the timed calls, the last result); the H100 bound model on bytes and
operations counted by hand; ``chip_smoke.py`` takes the model from
``utils.roofline`` and defines none of it itself; and the port has a
counterpart of every module of the JAX package (the kernel modules
renamed, plus modules of its own).
"""

import ast
import os

import numpy as np
import pytest
import torch

from speech_recognition_tpu.utils.profiling import Meter as JMeter
from speech_recognition_tpu_torch.utils import roofline
from speech_recognition_tpu_torch.utils.profiling import Meter, timed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVED = ("HBM_BYTES_PER_S", "F32_OPS_PER_S", "SFU_PER_S", "SMEM_STEP_CYCLES", "SM_CLOCK_HZ",
         "bound", "nbytes", "graph_bytes", "dp_ops", "span_pairs", "ceps_ops", "dense_ops",
         "mfcc_ops", "tail_ops", "rescore_ops", "fb_steps", "_fin", "fb_dense_work",
         "fb_banded_work")


def test_meter_matches_reference():
    adds = [("mfcc", 0.5, 5000, 10), ("decode", 0.25, 5000, 10), ("mfcc", 0.25, 1000, 2),
            ("idle", 0.0, 0, 0), ("align", 2.0, 0, 7), ("decode", 1.5, 300, 0)]
    got, want = Meter(frame_step_s=0.01), JMeter(frame_step_s=0.01)
    for a in adds:
        got.add(*a)
        want.add(*a)
    assert got.totals == want.totals
    g, w = got.report(), want.report()
    assert g.keys() == w.keys() and "idle.seconds" not in g
    for k in w:
        assert g[k] == pytest.approx(w[k], rel=1e-12), k
    assert g["mfcc.audio_s_per_s"] == pytest.approx(60.0 / 0.75)


def test_timed_on_the_cpu():
    """The host clock on the CPU: ``warmup`` calls, then ``iters`` timed
    ones; the median per call and the last result."""
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return torch.full((3,), x * scale)

    sec, out = timed(fn, 2.0, warmup=3, iters=4, device="cpu", scale=0.5)
    assert len(calls) == 7 and torch.equal(out, torch.full((3,), 1.0))
    assert 0.0 <= sec < 1.0
    sec, _ = timed(lambda: sum(range(200000)), warmup=0, iters=3, device="cpu")
    assert sec > 0.0


def test_bound_on_hand_counted_work():
    """The larger of bytes over 3.35 TB/s and operations over 67 T/s
    (exps and logs over the SFUs' 132 x 16 a clock at 1.98 GHz)."""
    ms, by = roofline.bound(3.35e9, 1e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = roofline.bound(1e6, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    sfu = 132 * 16 * 1.98e9
    ms, by = roofline.bound(0, 1.0, sfu * 2e-3)
    assert by == "operations" and ms == pytest.approx(2.0)
    x = torch.zeros((10, 7), dtype=torch.float32)
    assert roofline.nbytes(x, None, torch.zeros(5, dtype=torch.int8)) == 285
    assert roofline.dense_ops(100, 5, 2) == 100 * 5 * 5 * 2 * 3
    assert roofline.rescore_ops(10, 2, 3, 4, dense=False) == 10 * 2 * 3 * (6 + 8)
    assert roofline.rescore_ops(10, 2, 3, 4, dense=True) == 10 * 2 * 3 * 9
    fw, bw, n = roofline.fb_steps(torch.tensor([0, 1, 5, 9]), 6)
    assert fw.tolist() == [1, 1, 5, 6] and bw.tolist() == [0, 0, 4, 5] \
        and n.tolist() == [0, 1, 5, 6]
    line = roofline.report({"K1": (1.5, "bytes"), "K2": (0.5, "operations")}, 4e-3)
    assert "bound 2.0000 ms" in line and "50.0% of the bound" in line and "K2: 0.5000 ms" in line


def test_dp_ops_counts_band_eps_and_cross_work():
    """Per frame and stream: 8 operations a state (3 more with cross
    edges), 2 per eps pair and 2 per word, times the passes."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    g = banded_arrays(build_loop_graph([uniform_left_to_right_trans(5) for _ in range(4)]))
    assert roofline.dp_ops(g, 10) == 10 * (20 * 8 + 2 * 16 + 2 * 4)
    assert roofline.dp_ops(g, 10, eps_pairs=4, passes=2) == 10 * (20 * 8 + 2 * (8 + 8))
    assert roofline.graph_bytes(g) == 4 * (3 * 20 + 20 + 20 + 4 + 4 + 16)
    crossed = g._replace(cross_src=torch.zeros(20, dtype=torch.int64),
                         cross_cost=torch.zeros(20))
    assert roofline.dp_ops(crossed, 1) == 20 * 11 + 2 * 16 + 2 * 4


def test_chip_smoke_takes_the_bound_model_from_roofline():
    """``chip_smoke.py`` defines none of the bound model's names and
    imports them from ``utils.roofline``; ``cuda_ms`` times through
    ``utils.profiling.timed``."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    defined = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            defined.update(t.id for t in node.targets if isinstance(t, ast.Name))
    assert not defined & set(MOVED), defined & set(MOVED)
    imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                and node.module == "speech_recognition_tpu_torch.utils.roofline"
                for a in node.names}
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)} & set(MOVED)
    assert used and used <= imported
    timed_from = {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                  and any(a.name == "timed" for a in node.names)}
    assert timed_from == {"speech_recognition_tpu_torch.utils.profiling"}
    assert all(hasattr(roofline, n) for n in MOVED)


def test_port_has_a_counterpart_of_every_module():
    """Every module of the JAX package has one of the same path in the
    port, but for the Pallas kernel modules, whose CUDA wrappers have
    their own names; the port's own modules are the wrappers, the
    lexicon helpers and the kernel build."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                for f in fs if f.endswith(".py")}

    jax_mods, port_mods = modules("speech_recognition_tpu"), modules(
        "speech_recognition_tpu_torch")
    renamed = {"ops/frontend_pallas.py", "ops/pallas_kernels.py", "ops/viterbi_banded_pallas.py",
               "ops/viterbi_lex_pallas.py"}
    own = {"data/lexicon.py", "ops/beam_kernels.py", "ops/forward_backward_kernels.py",
           "ops/frontend_kernel.py",
           "ops/gmm_fit_kernels.py", "ops/lattice_kernels.py", "ops/viterbi_banded_kernels.py", "ops/viterbi_kernels.py",
           "ops/viterbi_lex_kernels.py", "utils/build.py"}
    assert jax_mods - port_mods == renamed
    assert port_mods - jax_mods == own
    assert np.all([m in port_mods for m in ("parallel/mesh.py", "parallel/trainer.py",
                                            "parallel/sharded_decode.py",
                                            "utils/profiling.py", "utils/roofline.py")])
