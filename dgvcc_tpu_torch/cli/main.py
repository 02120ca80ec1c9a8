"""Command line of the port.

    python -m dgvcc_tpu_torch --config configs/X.yml \
        --task {train,test,vis,train_test,generate,serve,quantize,aot,export}
        [--ckpt x.pth] [--device cpu] [--frames DIR | --http PORT] [--batch N]
        [--quantize [auto] | --artifact FILE | --aot FILE] [--out FILE]
        [--shapes BxHxW[,...] --platforms cuda,cpu] [--template ref.pth]
    torchrun --nproc_per_node=N -m dgvcc_tpu_torch --config X.yml \
        --task {train,test,train_test,serve} [--dist-backend gloo]
        (N: the mesh's ranks, data x model, or spatial; serve: the serving mesh's)

Reads the JAX package's YAML configs (core/config.py). ``train``, ``test``,
``vis``, ``train_test`` and ``generate`` drive
``train/trainer.py::DGTrainer`` (the log dir gets a snapshot of the config;
``--task test`` needs a checkpoint; ``--ckpt gen.pth,reg.pth`` is a joint
run's [gen, reg] pair; ``generate`` writes restyled train images with a
generation or joint run's generator).
``--task serve --frames DIR`` streams per-frame counts over a directory of
images and prints one ``name count`` line per frame and a throughput
summary; ``--task serve --http PORT`` answers ``POST /count`` with image
bytes (``serve_http.py``), ``--batch`` bounding its micro-batch. The
device is ``cuda`` unless ``--device`` or the config's ``device:`` key
starts with ``cpu``.

Int8 (``nn/quant.py``): ``--task quantize --frames DIR --out FILE`` folds
the checkpoint, calibrates on the first frames of DIR and writes an int8
artifact (``nn/quant_io.py``, the JAX package's format); ``--task serve
--artifact FILE`` serves one with no checkpoint and no calibration;
``--task serve --quantize`` calibrates on ``--frames`` and serves int8,
``--quantize auto`` keeps both graphs and picks one per dispatch
(``serve.py``; the config's ``auto_threshold`` key sets its batch rule).

A config with a mesh trains, validates and tests under ``torchrun
--nproc_per_node=N`` (``parallel/``): ``mesh: {data: N}`` data parallel,
``mesh: {data: N, model: M}`` with N M ranks and the bank sharded over the
model axis, ``mesh: {spatial: N}`` with the crop's height sharded. Rank r
takes ``cuda:{LOCAL_RANK}`` and NCCL; ``--device cpu`` takes gloo, and
``--dist-backend gloo`` lets ranks share a card (NCCL with more local ranks
than cards raises). Outside torchrun, or with another number of ranks, it
raises. ``vis``, ``generate``, ``quantize`` and ``export`` run in one
process on such a config, the mesh ignored (a console line says so), as
the JAX command line runs them; ``aot`` refuses a mesh.

``--task serve`` serves on a mesh of N ranks under ``torchrun
--nproc_per_node=N`` (``parallel/serving.py``), N by the JAX command
line's rule: ``mesh.spatial`` under ``serve_shard: spatial`` (each frame's
height sharded, the DG family), else ``mesh.data`` (the batch sharded);
N = 1 serves in one process. With ``--frames`` every rank reads the same
files and counts them together, and rank 0 prints. With ``--http`` rank 0
serves HTTP and sends each batch to the other ranks, which count it with
it until rank 0 stops. ``--aot`` serves single-device programs and refuses
a mesh, as the fleet (one process on one card a replica) refuses one.

AOT (``nn/aot.py``): ``--task aot --shapes BxHxW[,...] --out FILE
[--platforms cuda,cpu]`` exports the serving program of the checkpoint
(int8 with ``--quantize`` and ``--frames``) or of an int8 ``--artifact``,
one ``torch.export`` program a shape; ``--task serve --aot FILE`` serves
one with no model built and no checkpoint read. ``--task export --ckpt
X --template ref.pth --out dest.pth`` writes a checkpoint (a JAX ``.ckpt``
or a ``.pth``, strict-loaded through the trainer; a joint config's
regressor) under the template's keys and shapes, for the reference's
``load_state_dict``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

TASKS = ("train", "test", "vis", "train_test", "generate", "serve", "export",
         "quantize", "aot")


def _list_images(frames_dir: str):
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    names = sorted(fn for fn in os.listdir(frames_dir)
                   if fn.lower().endswith(exts))
    if not names:
        raise SystemExit(f"no images under {frames_dir}")
    return names


def _load_calib(frames_dir: str, n: int = 4):
    """The first ``n`` frames of a directory at 256x256, the calibration
    frames the JAX package's command line takes."""
    import numpy as np
    from PIL import Image

    names = _list_images(frames_dir)
    return np.stack([np.asarray(Image.open(os.path.join(frames_dir, fn)).convert("RGB")
                                .resize((256, 256)), np.uint8) for fn in names[:max(1, n)]])


def _build_counter(cfg, device: str, quantize=False, artifact: str = None,
                   frames_dir: str = None, batch: int = 4, aot: str = None, mesh=None,
                   shard: str = "batch"):
    """An AOT artifact's ``AotCounter`` (no model built), an int8
    ``artifact``, or the config's checkpoint (a reference or port ``.pth``;
    seeded random weights when it names none) in its ``compute_dtype``, int8
    with ``quantize`` (calibrated on the first frames of ``frames_dir``);
    on ``mesh`` (a serving mesh's process group) sharded by ``shard``."""
    import torch

    from dgvcc_tpu_torch.serve import VideoCounter

    if aot is not None:
        from dgvcc_tpu_torch.nn.aot import AotCounter

        if not os.path.isfile(aot):
            raise SystemExit(f"--aot {aot}: no such file (--task aot writes one)")
        try:
            return AotCounter.load(aot, device=device)
        except ValueError as e:
            raise SystemExit(f"--aot {aot}: {e}")
    if artifact is not None:
        if quantize == "auto":
            # an artifact holds only the int8 graph: no fp weights for the
            # dispatches auto would serve in bf16
            raise SystemExit("--quantize auto cannot serve an --artifact: the int8 artifact "
                             "has no fp weights for the bf16 path. Serve the checkpoint with "
                             "--quantize auto, or the artifact without it")
        if not os.path.isfile(artifact):
            raise SystemExit(f"--artifact {artifact}: no such file (--task quantize writes one)")
        return VideoCounter.from_artifact(artifact, log_para=cfg.log_para, device=device,
                                          mesh=mesh, shard=shard)
    calib = None
    if quantize:
        if frames_dir is not None:
            calib = _load_calib(frames_dir, n=max(1, min(batch, 4)))
        elif quantize != "auto":
            # auto may calibrate lazily on its first int8 dispatch; int8 cannot
            raise SystemExit("--quantize without --artifact needs --frames DIR for scale "
                             "calibration")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return VideoCounter.from_checkpoint(
        cfg.model["name"], cfg.checkpoint, log_para=cfg.log_para,
        dtype=dtype, device=device, seed=cfg.seed, quantize=quantize, calib_frames=calib,
        auto_threshold=cfg.extra.get("auto_threshold"), mesh=mesh, shard=shard,
        **cfg.model.get("params", {}))


def _quantize(cfg, frames_dir: str, out: str, device: str):
    """``--task quantize``: fold the checkpoint, calibrate on the first frames
    of ``frames_dir`` and write an int8 artifact to ``out``."""
    from dgvcc_tpu_torch.nn.quant_io import save_quantized

    if cfg.checkpoint is None:
        raise SystemExit("--task quantize requires a checkpoint (config key 'checkpoint' "
                         "or --ckpt)")
    if frames_dir is None or out is None:
        raise SystemExit("--task quantize requires --frames DIR (calibration imagery) and "
                         "--out ARTIFACT")
    counter = _build_counter(cfg, device, quantize=True, frames_dir=frames_dir)
    q = counter.quantized
    params = {k: v for k, v in cfg.model.get("params", {}).items() if k != "pretrained"}
    save_quantized(q, out, model_name=cfg.model["name"], model_params=params)
    n8 = len(q.int8_sites())
    print(f"[quantize] wrote {out}: {n8} int8 sites (+{len(q.sites) - n8} fp)")


def _parse_shapes(shapes: str):
    try:
        parsed = [tuple(int(x) for x in tok.lower().split("x")) for tok in shapes.split(",")]
    except ValueError:
        parsed = None
    if not parsed or any(len(t) != 3 or min(t) < 1 for t in parsed):
        raise SystemExit(f"--shapes must be BxHxW[,BxHxW...], got {shapes!r}")
    return parsed


def _aot_export(cfg, shapes: str, platforms: str, out: str, device: str, quantize=False,
                artifact: str = None, frames_dir: str = None, batch: int = 4):
    """``--task aot``: one ``torch.export`` serving program for each --shapes
    entry (BxHxW), for the --platforms devices (default: this run's), of
    the checkpoint (int8 with --quantize) or of an int8 --artifact; the file
    serves with ``--task serve --aot OUT``."""
    from dgvcc_tpu_torch.nn.aot import export_serving, save_aot

    if out is None or shapes is None:
        raise SystemExit("--task aot requires --out FILE and --shapes BxHxW[,BxHxW...] "
                         "(e.g. --shapes 1x1080x1920,4x720x1280)")
    if quantize == "auto":
        raise SystemExit("--task aot exports ONE program per shape — pick the precision: "
                         "--quantize (int8) or none (bf16); export both files to serve "
                         "adaptively")
    if artifact is None and cfg.checkpoint is None:
        raise SystemExit("--task aot requires a checkpoint (config key 'checkpoint' or "
                         "--ckpt) or an int8 --artifact")
    parsed = _parse_shapes(shapes)
    plats = [p.strip() for p in platforms.split(",") if p.strip()] if platforms else None
    counter = _build_counter(cfg, device, quantize, artifact, frames_dir, batch)
    try:
        doc = export_serving(counter, parsed, platforms=plats)
    except ValueError as e:
        raise SystemExit(f"--task aot: {e}")
    save_aot(doc, out)
    print(f"[aot] wrote {out}: {len(doc['programs'])} programs {sorted(doc['programs'])} "
          f"for platforms {doc['platforms']}{' (int8)' if doc['quantized'] else ''}")


def _export(cfg, template: str, out: str, device: str):
    """``--task export``: the checkpoint, strict-loaded through the trainer,
    written under the template's keys and shapes (``nn/convert.py::
    export_reference_state_dict``); a joint config exports its regressor."""
    import torch

    from dgvcc_tpu_torch.nn.convert import export_reference_state_dict, load_reference_pth
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    if cfg.checkpoint is None:
        raise SystemExit("--task export requires a checkpoint (config key 'checkpoint' "
                         "or --ckpt)")
    if template is None or out is None:
        raise SystemExit("--task export requires --template ref.pth (a same-architecture "
                         "reference state_dict, for torch key names/shapes) and --out "
                         "dest.pth")
    # the weights as stored, not rounded to a bf16 compute dtype
    cfg.compute_dtype = "float32"
    trainer = DGTrainer(cfg, device=device)
    if trainer.joint:
        # export targets the counting regressor: a [gen]-only checkpoint
        # would export its random initial weights
        if isinstance(cfg.checkpoint, (list, tuple)) and len(cfg.checkpoint) < 2:
            raise SystemExit("--task export on a joint config needs the regressor "
                             "checkpoint too: checkpoint: [gen.ckpt, reg.ckpt]. To export "
                             "the generator, use a gen-family config.")
        print("[export] joint config: exporting the counting regressor (use a gen-family "
              "config to export the generator)")
    trainer.build()
    trainer.load_ckpt(cfg.checkpoint, strict=True)
    sd = export_reference_state_dict(trainer.model, load_reference_pth(template))
    torch.save(sd, out)
    print(f"[export] wrote {len(sd)} tensors to {out}")


def _serve(cfg, frames_dir: str, batch: int, device: str, quantize=False,
           artifact: str = None, aot: str = None, mesh=None, shard: str = "batch"):
    """Stream per-frame crowd counts over a directory of images: decode on
    the host, batch consecutive same-shape frames, pipeline them through
    VideoCounter.stream. On a mesh every rank streams the same files and
    rank 0 alone prints."""
    import numpy as np
    import torch
    from PIL import Image

    names = _list_images(frames_dir)
    counter = _build_counter(cfg, device, quantize, artifact, frames_dir, batch, aot, mesh,
                             shard)
    main = mesh is None or counter.rank == 0
    # a stream has few shapes (one per bucket): let cuDNN time its choices
    torch.backends.cudnn.benchmark = True

    def batches():
        buf, buf_names = [], []
        for n in names:
            img = np.asarray(Image.open(os.path.join(frames_dir, n))
                             .convert("RGB"), np.uint8)
            if buf and (img.shape != buf[-1].shape or len(buf) >= batch):
                yield buf_names, np.stack(buf)
                buf, buf_names = [], []
            buf.append(img)
            buf_names.append(n)
        if buf:
            yield buf_names, np.stack(buf)

    name_stream = []

    def frame_stream():
        for bn, frames in batches():
            name_stream.append(bn)
            yield frames

    t0 = time.perf_counter()
    total = 0
    for counts in counter.stream(frame_stream()):
        bn = name_stream.pop(0)
        for n, c in zip(bn, counts):
            if main:
                print(f"{n} {float(c):.2f}")
        total += len(bn)
    dt = time.perf_counter() - t0
    on = "" if mesh is None else f" x {counter.n_shards} ranks ({shard})"
    if main:
        print(f"[serve] {total} frames in {dt:.2f}s = {total / dt:.2f} fps "
              f"on {counter.device}{on}{' (int8)' if counter.quantized is not None else ''}")


def _serve_http(cfg, port: int, batch: int, device: str, block: bool = True,
                quantize=False, artifact: str = None, frames_dir: str = None,
                aot: str = None, mesh=None, shard: str = "batch"):
    """``--task serve --http PORT``: POST /count with image bytes returns
    {"count": N} (serve_http.py); ``batch`` bounds the request
    micro-batch (and the number of calibration frames). ``block=False``
    serves on a daemon thread and returns the server (tests, embedding).
    On a mesh rank 0 serves HTTP (a ``Leader``) and the other ranks follow
    it until it shuts down, which stops them."""
    from dgvcc_tpu_torch.parallel.serving import Leader, follow
    from dgvcc_tpu_torch.serve_http import CountingServer

    counter = _build_counter(cfg, device, quantize, artifact, frames_dir, batch, aot, mesh,
                             shard)
    if mesh is not None and counter.rank > 0:
        follow(counter)
        return None
    srv = CountingServer(counter if mesh is None else Leader(counter), host="0.0.0.0",
                         port=port, model_name=cfg.model["name"], max_batch=batch)
    if not block:
        srv.start()
        return srv
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()  # on a mesh: the dispatcher stops the other ranks


def _trainer_task(cfg, config_path: str, task: str, device: str):
    from dgvcc_tpu_torch.train.trainer import DGTrainer

    trainer = DGTrainer(cfg, device=device)
    if trainer.main:
        # snapshot the config into the log dir (reference main.py:151)
        shutil.copy(config_path, os.path.join(trainer.log_dir, os.path.basename(config_path)))
    if task == "train":
        trainer.train()
    elif task == "test":
        if cfg.checkpoint is None:
            raise SystemExit("--task test requires a checkpoint (config key 'checkpoint' "
                             "or --ckpt): random weights would report garbage metrics")
        trainer.build()
        trainer.load_ckpt(cfg.checkpoint)
        trainer.test()
    elif task == "vis":
        trainer.vis(checkpoint=cfg.checkpoint)
    elif task == "generate":
        trainer.generate(checkpoint=cfg.checkpoint)
    else:
        trainer.train_and_test()


def _mesh_task(cfg, config_path: str, task: str, device: str, backend):
    """A torchrun job's rank: join the process group (the trainer checks its
    size against the mesh), run the task, and leave the group if it joined
    it here."""
    import torch.distributed as dist

    from dgvcc_tpu_torch.parallel.multihost import initialize_distributed

    owned = not dist.is_initialized()
    initialize_distributed(backend, device)
    try:
        return _trainer_task(cfg, config_path, task, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def run(config_path: str, task: str, frames: str = None, batch: int = 4,
        ckpt: str = None, device: str = None, http: int = None,
        quantize=False, artifact: str = None, aot: str = None, block: bool = True,
        dist_backend: str = None, out: str = None, shapes: str = None,
        platforms: str = None, template: str = None):
    from dgvcc_tpu_torch.core.config import load_config
    from dgvcc_tpu_torch.train.trainer import config_device, mesh_size

    cfg = load_config(config_path)
    if cfg.extra.get("compile_cache"):
        # the JAX package turns on XLA's persistent compilation cache from it
        print(f"[config] compile_cache: {cfg.extra['compile_cache']!r} has no effect in "
              "dgvcc_tpu_torch: there is no XLA program to cache; the CUDA kernels' nvcc "
              "builds are kept in build/torch_ext/ and reused while their sources are "
              "unchanged", file=sys.stderr)
    if ckpt is not None:
        # a comma pair is a joint run's [gen, reg] checkpoint
        cfg.checkpoint = ckpt.split(",") if "," in ckpt else ckpt
    if task in ("serve", "quantize", "aot") and isinstance(cfg.checkpoint, (list, tuple)):
        raise SystemExit(f"--task {task} takes a single checkpoint path; for a joint run "
                         "pass the counting regressor's checkpoint (the _reg one)")
    axes = {a: mesh_size(cfg, a) for a in ("data", "model", "spatial")}
    axes = {a: n for a, n in axes.items() if n > 1}
    if task == "serve":
        return _serve_task(cfg, frames, batch, config_device(cfg, device), http, quantize,
                           artifact, aot, block, dist_backend)
    mesh = ", ".join(f"{a}: {n}" for a, n in axes.items())
    if axes and task == "aot":
        raise SystemExit(f"--task aot with mesh: {{{mesh}}}: it runs in one process on "
                         "one card; drop the mesh key for it")
    if axes and task in ("vis", "generate", "quantize", "export"):
        # what these write does not depend on the mesh (the JAX command line
        # runs them on such a config too)
        print(f"[mesh] --task {task} runs in one process on one card: mesh: {{{mesh}}} "
              "is ignored for it", flush=True)
        cfg.mesh = {}
    if task == "quantize":
        return _quantize(cfg, frames, out, config_device(cfg, device))
    if task == "aot":
        return _aot_export(cfg, shapes, platforms, out, config_device(cfg, device), quantize,
                           artifact, frames, batch)
    if task == "export":
        return _export(cfg, template, out, config_device(cfg, device))
    if task != "serve":
        if axes:
            return _mesh_task(cfg, config_path, task, config_device(cfg, device),
                              dist_backend)
    return _trainer_task(cfg, config_path, task, config_device(cfg, device))


def _serve_task(cfg, frames, batch, device, http, quantize, artifact, aot, block,
                dist_backend):
    """``--task serve``: on the config's serving mesh (dgvcc_tpu/cli/main.py:
    131-158), joined here from torchrun's environment and left here if it
    was joined here, or in one process."""
    import torch.distributed as dist

    from dgvcc_tpu_torch.parallel.serving import serving_mesh, serving_mesh_size
    from dgvcc_tpu_torch.train.trainer import mesh_size

    n, shard = serving_mesh_size(cfg)
    if shard == "spatial" and n <= 1:
        # `serve_shard: spatial` slices each frame's height over a mesh
        raise SystemExit("serve_shard: spatial needs a mesh — set mesh: {spatial: N} (or "
                         "mesh: {data: N}) in the config")
    if aot is not None and (mesh_size(cfg, "data") > 1 or mesh_size(cfg, "spatial") > 1):
        raise SystemExit("--aot serves single-device programs; for data-parallel deployment "
                         "run one replica process per card, each loading the same AOT file")
    if http is None and frames is None:
        raise SystemExit("--task serve requires --frames DIR (or --http PORT)")
    owned = not dist.is_initialized()
    try:
        mesh = serving_mesh(n, dist_backend, device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--task serve: {e}")
    try:
        if http is not None:
            return _serve_http(cfg, http, batch, device, block=block, quantize=quantize,
                               artifact=artifact, frames_dir=frames, aot=aot, mesh=mesh,
                               shard=shard)
        _serve(cfg, frames, batch, device, quantize, artifact, aot, mesh, shard)
    finally:
        if owned and block and dist.is_initialized():
            dist.destroy_process_group()


def build_parser():
    parser = argparse.ArgumentParser(
        description="dgvcc_tpu_torch: the PyTorch / CUDA port of dgvcc_tpu")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--task", type=str, default="serve", choices=TASKS)
    parser.add_argument("--frames", type=str, default=None,
                        help="image directory for --task serve")
    parser.add_argument("--batch", type=int, default=4,
                        help="serving batch size (with --http: the request micro-batch's "
                             "bound)")
    parser.add_argument("--http", type=int, default=None,
                        help="--task serve: listen on this port instead of reading "
                             "--frames (POST /count, GET /healthz, /stats, /metrics); on "
                             "a mesh rank 0 listens")
    parser.add_argument("--quantize", nargs="?", const=True, default=False,
                        choices=[True, False, "auto"], metavar="auto",
                        help="--task serve: the int8 graph, calibrated on --frames; 'auto' "
                             "keeps both graphs and picks one per dispatch")
    parser.add_argument("--artifact", type=str, default=None,
                        help="--task serve: an int8 artifact (--task quantize's output), "
                             "served without checkpoint or calibration")
    parser.add_argument("--out", type=str, default=None,
                        help="--task quantize / aot: the artifact to write; --task export: "
                             "the .pth to write")
    parser.add_argument("--aot", type=str, default=None,
                        help="--task serve: an AOT artifact (--task aot's output), served "
                             "with no model built and no checkpoint read")
    parser.add_argument("--shapes", type=str, default=None,
                        help="--task aot: BxHxW[,BxHxW...], the batches and frame sizes to "
                             "export (padded to the 64-bucket)")
    parser.add_argument("--platforms", type=str, default=None,
                        help="--task aot: the devices the artifact may serve on, from "
                             "cuda,cpu (default: the export's device)")
    parser.add_argument("--template", type=str, default=None,
                        help="--task export: a same-architecture reference .pth for the "
                             "torch key names and shapes")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="override the config's checkpoint: key (.pth; gen,reg for a "
                             "joint run's pair)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda[:N] or cpu; overrides the config's device:")
    parser.add_argument("--dist-backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="a mesh under torchrun (training, or --task serve with mesh "
                             "and serve_shard): the process group's backend (default nccl "
                             "on the card, gloo on the CPU; gloo lets ranks share a card)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.config, args.task, frames=args.frames, batch=args.batch,
        ckpt=args.ckpt, device=args.device, http=args.http, quantize=args.quantize,
        artifact=args.artifact, aot=args.aot, dist_backend=args.dist_backend, out=args.out,
        shapes=args.shapes, platforms=args.platforms, template=args.template)


if __name__ == "__main__":
    main()
