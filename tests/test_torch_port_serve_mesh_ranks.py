"""The rank side of the mesh serving tests (this module holds no tests):
cases run on every rank of a gloo group started by
``dgvcc_tpu_torch.parallel.launch.run_ranks``. Like
tests/test_torch_port_mesh_ranks.py it imports neither JAX nor the tests'
conftest, and shares its file protocol.

``run_cases(rank, workdir)`` reads ``workdir/spec.pt``, runs each case on
this rank and writes ``workdir/rank{r}.pt``.
"""

import contextlib
import io
import json
import os
import urllib.request

import numpy as np
import torch

import dgvcc_tpu_torch.models  # noqa: F401
from dgvcc_tpu_torch.core.registry import MODELS
from dgvcc_tpu_torch.parallel.mesh import make_mesh
from dgvcc_tpu_torch.serve import VideoCounter


TINY_CCTRANS = dict(embed_dims=(32, 64, 128, 256), num_heads=(2, 4, 8, 16),
                    depths=(1, 1, 2, 1), wss=(4, 4, 4, 4), sr_ratios=(8, 4, 2, 1))


def _model(spec, family):
    name, params, state_dict = spec["families"][family]
    model = MODELS.build(name, **params)
    model.load_state_dict(state_dict, strict=True)
    return model


def _counter(spec, family, mesh, shard, **kw):
    return VideoCounter(_model(spec, family), dtype=torch.float32, device="cpu", mesh=mesh,
                        shard=shard, **spec["tiles"], **kw)


def case_counts(rank, spec):
    """Counts of each family and shard on the 2-rank mesh, by frame set:
    count_frames of each, and the sets streamed in one pipeline."""
    mesh = make_mesh(2)
    out = {}
    for family, shard, sets in spec["runs"]:
        c = _counter(spec, family, mesh, shard)
        for key in sets:
            out[family, shard, key] = c.count_frames(spec["frames"][key])
        streamed = list(c.stream(iter(spec["frames"][k] for k in sets), prefetch=2))
        for key, counts in zip(sets, streamed):
            out[family, shard, key, "stream"] = counts
    try:  # a family that does not shard its rows yet: CCTrans (tiny)
        VideoCounter(MODELS.build("cctrans", **TINY_CCTRANS), dtype=torch.float32,
                     device="cpu", mesh=mesh, shard="spatial")
    except NotImplementedError as e:
        out["refused"] = str(e)
    return out


def case_int8(rank, spec):
    """An int8 artifact served batch-sharded and spatially, and the scales of
    a graph calibrated on the mesh, at construction and lazily."""
    mesh = make_mesh(2)
    out = {}
    for shard in ("batch", "spatial"):
        c = VideoCounter.from_artifact(spec["artifact"], dtype=torch.float32, device="cpu",
                                       mesh=mesh, shard=shard, **spec["tiles"])
        for key in spec["sets"]:
            out[shard, key] = c.count_frames(spec["frames"][key])
    frames = spec["frames"][spec["sets"][0]]
    built = _counter(spec, "final", mesh, "spatial", quantize=True, calib_frames=frames)
    lazy = _counter(spec, "final", mesh, "batch", quantize=True)
    lazy.count_frames(frames)
    out["scales"] = {"built": built.quantized.scales, "lazy": lazy.quantized.scales}
    return out


def case_dispatch(rank, spec):
    """``_dispatch_batch`` of each shard for each (B, H, W)."""
    mesh = make_mesh(2)
    out = {}
    for shard in ("batch", "spatial"):
        c = VideoCounter(torch.nn.Identity(), device="cpu", mesh=mesh, shard=shard,
                         **spec["tiles"]) if shard == "batch" else _counter(
                             spec, "final", mesh, shard)
        for shape in spec["shapes"]:
            out[shard, shape] = c._dispatch_batch(np.zeros(shape + (3,), np.uint8))
    return out


def case_cli_frames(rank, spec):
    """``--task serve --frames`` of the port's command line on this rank:
    what it printed."""
    from dgvcc_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(spec["argv"])
    return buf.getvalue()


def case_cli_http(rank, spec):
    """``--task serve --http 0`` on the mesh: rank 0 posts each JPEG to its
    own server and shuts it down; the other ranks follow until then."""
    from dgvcc_tpu_torch.cli.main import run

    srv = run(*spec["args"], **spec["kwargs"])
    if rank > 0:
        return {"follower_returned": srv is None}
    counts = []
    try:
        for path in spec["images"]:
            with open(path, "rb") as f:
                req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/count",
                                             data=f.read(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                counts.append(json.load(r)["count"])
        stats = srv.stats()
    finally:
        srv.shutdown()
    return {"counts": counts, "stats": stats}


CASES = {"counts": case_counts, "int8": case_int8, "dispatch": case_dispatch,
         "cli_frames": case_cli_frames, "cli_http": case_cli_http}


def run_cases(rank, workdir):
    """Every case of ``workdir/spec.pt`` in order, on every rank."""
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    out = {}
    for key, (case, inputs) in spec.items():
        out[key] = CASES[case](rank, inputs)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
