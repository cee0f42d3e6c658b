"""One rank of the port's multi-process CPU tests (``tests/torch_world.py``
starts the world).

    python tests/torch_parallel_worker.py <suite> <rank> <world> <dir>

Joins a gloo world through a ``FileStore`` in ``dir``, reads
``dir/inputs.npz`` (made by the test module from numpy seeds; banks and
graphs as plain arrays), runs ``suite`` ("train" or "decode") and writes
``dir/out_<rank>.npz``.  Imports only the port, torch and numpy: the
JAX references are computed by the test process.
"""

import os
import sys
import traceback

import numpy as np
import torch

# the test process's run tables (imported by the test modules too)
# name: (case, graph dict, mesh shape, shard_models, soft)
TRAIN_RUNS = {
    "hard_4x1": ("a", "a_hard", (4, 1), False, False),
    "hard_2x2_12models": ("b", "b_hard", (2, 2), True, False),
    "soft_dense_4x1": ("a", "a_dense", (4, 1), False, True),
    "soft_banded_4x1": ("a", "a_band", (4, 1), False, True),
    "soft_banded_2x2_12models": ("b", "b_band", (2, 2), True, True),
}
# name: (case, mesh shape)
CLASSIFY_RUNS = {"classify_4x1": ("a", (4, 1)), "classify_2x2": ("b", (2, 2))}
# name: (beam width, "mesh": a (1, world) mesh's 'model' axis, "group": the
# default group)
DECODE_CASES = {
    "sausage": (0, "mesh"),
    "loop": (0, "group"),
    "lexgraph": (0, "mesh"),
    "one_state_sausage": (0, "group"),
    "dead_head": (0, "mesh"),
    "beam7": (7, "mesh"),
    "beam20": (20, "group"),
}
BANK_FIELDS = ("means", "log_vars", "log_weights", "trans_cost")
GRAPH_FIELDS = ("band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos",
                "is_start", "end_states", "end_bonus", "bank_state", "cross_src", "cross_cost")


def _bank(inp, case):
    from speech_recognition_tpu_torch.models.hmm import HMMBank

    return HMMBank.from_numpy(*(inp[f"{case}_bank_{f}"] for f in BANK_FIELDS))


def _graph_dict(inp, name):
    pre = f"{name}_g_"
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def suite_train(inp, world, out):
    import torch.distributed as dist

    from speech_recognition_tpu_torch import parallel
    from speech_recognition_tpu_torch.parallel.trainer import make_sharded_embedded_step

    for name, (case, gname, shape, shard_models, soft) in TRAIN_RUNS.items():
        mesh = parallel.make_mesh(shape, device_type="cpu")
        step = make_sharded_embedded_step(mesh, eps_depth=int(inp[f"{gname}_depth"]),
                                          shard_models=shard_models, soft=soft)
        new, stats = step(*parallel.shard_embedded_inputs(
            mesh, _bank(inp, case), inp[f"{case}_feats"], inp[f"{case}_nf"],
            _graph_dict(inp, gname), shard_models=shard_models))
        for f in BANK_FIELDS:
            out[f"{name}_{f}"] = getattr(new, f).numpy()
        for f in stats._fields:
            out[f"{name}_{f}"] = getattr(stats, f).numpy()
    for name, (case, shape) in CLASSIFY_RUNS.items():
        mesh = parallel.make_mesh(shape, device_type="cpu")
        classify = parallel.make_sharded_classifier(mesh)
        pred, costs = classify(parallel.bank_shard(mesh, _bank(inp, case)),
                               parallel.batch_shard(mesh, inp[f"{case}_feats"]),
                               parallel.batch_shard(mesh, inp[f"{case}_nf"]))
        out[f"{name}_pred"], out[f"{name}_costs"] = pred.numpy(), costs.numpy()

    def raises(fn, match):
        try:
            fn()
        except ValueError as e:
            return int(match in str(e))
        return 0

    mesh41 = parallel.make_mesh((4, 1), device_type="cpu")
    mesh22 = parallel.make_mesh((2, 2), device_type="cpu")
    out["err_shape_too_large"] = raises(lambda: parallel.make_mesh((4, 2), device_type="cpu"),
                                        "needs 8 ranks")
    out["err_cuda_without_nccl"] = raises(lambda: parallel.make_mesh(), "nccl")
    out["err_batch_does_not_divide"] = raises(
        lambda: parallel.batch_shard(mesh41, np.zeros((6, 3), np.float32)), "does not divide")
    three = _bank(inp, "a")
    three = type(three)(*(getattr(three, f)[:3] for f in BANK_FIELDS))
    out["err_models_do_not_divide"] = raises(
        lambda: parallel.bank_shard(mesh22, three, shard_models=True), "does not divide")
    # a second init is a no-op: the same world answers
    parallel.init_distributed(backend="gloo", rank=0, world_size=1)
    x = torch.ones(1)
    dist.all_reduce(x)
    out["init_twice_world"] = int(x.item())
    # a mesh over fewer ranks than the world: the others are outside it
    sub = parallel.make_mesh((2, 1), device_type="cpu")
    out["sub_mesh_member"] = int(sub.get_coordinate() is not None)


def suite_decode(inp, world, out):
    from speech_recognition_tpu_torch import parallel
    from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
    from speech_recognition_tpu_torch.parallel.sharded_decode import (
        gather_planes,
        make_sharded_banded_viterbi,
        pad_banded_for_sharding,
        state_slice,
    )
    from speech_recognition_tpu_torch.utils.numerics import POS_INF

    mesh = parallel.make_mesh((1, world), device_type="cpu")
    for name, (beam, via) in DECODE_CASES.items():
        f = _graph_dict(inp, name)
        g = BandedGraph(*(torch.from_numpy(f[k]) if k in f else None for k in GRAPH_FIELDS))
        gp, s = pad_banded_for_sharding(g, world)
        for k in GRAPH_FIELDS:
            if getattr(gp, k) is not None:
                out[f"{name}_pad_{k}"] = getattr(gp, k).numpy()
        nll = torch.from_numpy(inp[f"{name}_nll"])  # [T, S, B]
        pad = torch.full((nll.shape[0], gp.n_states - s, nll.shape[2]),
                         POS_INF if beam else 0.0)
        nll = torch.cat([nll, pad], 1)
        where = mesh if via == "mesh" else None
        run = make_sharded_banded_viterbi(where, gp, eps_depth=int(inp[f"{name}_depth"]),
                                          beam_width=beam)
        sl = state_slice(where, gp.n_states)
        final, bp8, eps_u = run(nll[:, sl].contiguous(), torch.from_numpy(inp[f"{name}_nf"]))
        final, bp8 = gather_planes(where, final, bp8)
        out[f"{name}_final"], out[f"{name}_bp8"] = final.numpy(), bp8.numpy()
        out[f"{name}_eps_u"] = eps_u.numpy()
        out[f"{name}_collectives"] = run.collectives_per_frame


def main():
    suite, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from speech_recognition_tpu_torch.parallel import init_distributed

    init_distributed(backend="gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                     rank=rank, world_size=world)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    {"train": suite_train, "decode": suite_decode}[suite](inp, world, out)
    dist.barrier()
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
