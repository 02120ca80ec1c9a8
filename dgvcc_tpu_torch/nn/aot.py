"""AOT serving artifacts, counterpart of dgvcc_tpu/nn/aot.py: the serving
program itself, serialized with ``torch.export``.

``export_serving`` captures a ``VideoCounter``'s whole-frame serving step
(uint8 frames (B, bh, bw, 3) and their valid extents (B, 2) int32 in, the
masked counts (B,) out: ``VideoCounter.masked_counts`` through the model or
the int8 graph, exactly what live serving runs) once for each (B, H, W) a
deployment will serve, padded to the counter's 64-bucket and keyed
``"{B}x{bh}x{bw}"``. ``AotCounter`` serves such a file with no model class
built and no checkpoint read.

The two serving kernels are ``torch.library`` custom ops
(``dgvcc_tpu_torch::memory_attention``, ``dgvcc_tpu_torch::qconv_int8``),
which their wrappers emit while ``torch.export`` traces. So a program holds
the op nodes, never their plain arithmetic, whatever device it was exported
on, and ``torch.export.passes.move_to_device_pass`` moves it to the card or
the CPU, where the op launches the kernel or runs its plain version: a CPU
build host can write artifacts for the card (``platforms=["cuda", "cpu"]``).

Weights: route (a), as the JAX format keeps them. They are program inputs,
not constants: the bf16 model's ``state_dict`` through
``torch.func.functional_call``, or the int8 graph's ``qparams`` (its sites'
int8 weights, scales and biases, the bank, the extras) flattened to one
dict and put back in place while the program is traced. The file stores
them once, beside one weight-free program a shape, so a file of several
shapes is barely larger than a file of one. The activation scales of an int8
graph are constants of its programs.

The file is a ``torch.save`` of {format, platforms, bucket, quantized,
torch_version, weights, programs: {key: ``torch.export.save`` bytes,
zlib-compressed}}. It is
not the JAX package's StableHLO file (``dgvcc-aot-v1``), which
``AotCounter`` refuses by name.
"""

from __future__ import annotations

import collections
import io
import math
import struct
import zlib
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

AOT_FORMAT = "dgvcc-torch-aot-v1"
PLATFORMS = ("cuda", "cpu")


def _padded_hw(h: int, w: int, bucket: int) -> Tuple[int, int]:
    return math.ceil(h / bucket) * bucket, math.ceil(w / bucket) * bucket


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) pairs of a nested dict of tensors, in its order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k, v in tree.items() for pair in _flatten(v, prefix + (k,))]


def _nest(pairs) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


class _Counts(torch.nn.Module):
    """The counter's masked counts as a module whose one child is its model,
    for ``torch.func.functional_call``."""

    def __init__(self, counter):
        super().__init__()
        self.model = counter.model
        self.__dict__["counter"] = counter

    def forward(self, frames, vh, vw):
        return self.counter.masked_counts(frames, vh, vw)


class _ServingProgram(torch.nn.Module):
    """(weights, frames (B, bh, bw, 3) uint8, valid (B, 2) int32) -> counts
    (B,). It holds no parameter: the counter is not a child."""

    def __init__(self, counter):
        super().__init__()
        self.__dict__["counter"] = counter
        if counter.quantized is not None:
            self.__dict__["paths"] = [p for p, _ in _flatten(counter.quantized.qparams)]
        else:
            self.__dict__["counts"] = _Counts(counter)

    def forward(self, weights: Dict[str, torch.Tensor], frames, valid):
        vh, vw = valid[:, 0], valid[:, 1]
        graph = self.counter.quantized
        if graph is None:
            return torch.func.functional_call(
                self.counts, {f"model.{k}": v for k, v in weights.items()}, (frames, vh, vw))
        saved = graph.qparams
        graph.qparams = _nest((p, weights["/".join(p)]) for p in self.paths)
        try:
            return self.counter.masked_counts(frames, vh, vw, use_q=True)
        finally:
            graph.qparams = saved


def _weights(counter) -> Dict[str, torch.Tensor]:
    """The program's weights input: the int8 graph's flattened ``qparams``,
    or the model's ``state_dict``, detached, on the counter's device."""
    if counter.quantized is not None:
        return {"/".join(p): t.detach() for p, t in _flatten(counter.quantized.qparams)}
    return {k: v.detach() for k, v in counter.model.state_dict().items()}


def export_serving(counter, shapes: Iterable[Tuple[int, int, int]],
                   platforms: Optional[List[str]] = None) -> Dict[str, Any]:
    """Export a VideoCounter's whole-frame serving program per shape.

    ``shapes``: the (batch, height, width) the deployment will serve; each
    pads to the counter's bucket, as live serving pads, and exports one
    program keyed by the padded shape. ``platforms``: the devices the file
    may be served on, from ``PLATFORMS`` (default: the counter's own)."""
    if getattr(counter, "mesh", None) is not None:
        raise ValueError("AOT export is single-device; serve artifact replicas data-parallel "
                         "by loading the file once per process/card")
    if getattr(counter, "auto", False):
        raise ValueError("quantize='auto' counters pick precision per dispatch and cannot "
                         "export a single program — build the counter with quantize=True "
                         "(int8) or False (fp) for AOT export")
    if getattr(counter, "_quant_pending", False):
        raise ValueError("quantized counter is uncalibrated — pass calib_frames (or count "
                         "one real batch) before export")
    plats = [p.lower() for p in platforms] if platforms else [counter.device.type]
    if not plats or any(p not in PLATFORMS for p in plats):
        raise ValueError(f"platforms must name some of {list(PLATFORMS)}, got {platforms!r}")
    weights = _weights(counter)
    program = _ServingProgram(counter)
    programs: Dict[str, bytes] = {}
    for b, h, w in shapes:
        if counter.tile_size and max(h, w) > counter.tile_threshold:
            raise ValueError(f"shape {b}x{h}x{w} exceeds tile_threshold="
                             f"{counter.tile_threshold}; AOT exports the whole-frame program "
                             "— raise the threshold or export smaller frames")
        bh, bw = _padded_hw(h, w, counter.bucket)
        key = f"{int(b)}x{bh}x{bw}"
        if key in programs:
            continue
        frames = torch.zeros((int(b), bh, bw, 3), dtype=torch.uint8, device=counter.device)
        valid = torch.zeros((int(b), 2), dtype=torch.int32, device=counter.device)
        ep = torch.export.export(program, (weights, frames, valid), strict=False)
        ep.example_inputs = None  # else saved with the program: the weights again
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        # the graph's JSON (node metadata, stack traces) shrinks about tenfold
        programs[key] = zlib.compress(buf.getvalue())
    return {"format": AOT_FORMAT, "platforms": plats, "bucket": int(counter.bucket),
            "quantized": counter.quantized is not None, "torch_version": str(torch.__version__),
            "weights": {k: v.cpu() for k, v in weights.items()}, "programs": programs}


def save_aot(doc: Dict[str, Any], path: str) -> None:
    torch.save(doc, path)


def read_aot(path: str) -> Dict[str, Any]:
    """An artifact's document; a file of another format is refused by name."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"PK\x03\x04":  # torch.save's zip archive
        from dgvcc_tpu_torch.utils.msgpack import unpackb

        try:
            doc = unpackb(data)
        except (ValueError, IndexError, struct.error):
            doc = None
        fmt = doc.get("format") if isinstance(doc, dict) else None
        whose = (" (the JAX package's StableHLO artifact: serve it with python -m "
                 "dgvcc_tpu.cli.main, or export this one with python -m dgvcc_tpu_torch "
                 "--task aot)" if fmt == "dgvcc-aot-v1" else "")
        raise ValueError(f"{path}: not a {AOT_FORMAT} artifact (format={fmt!r}){whose}")
    doc = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(doc, dict) or doc.get("format") != AOT_FORMAT:
        fmt = doc.get("format") if isinstance(doc, dict) else None
        raise ValueError(f"{path}: not a {AOT_FORMAT} artifact (format={fmt!r})")
    return doc


class AotCounter:
    """Serve counts from an AOT artifact: no model code, no checkpoint.

    What ``serve_http.py`` and the command line read of a VideoCounter
    (``count_frames``, ``stream``, ``quantized``, ``dispatches``,
    ``device``). Dispatch, as the JAX package's: a frame batch pads to the
    bucket, then runs the program for that padded (H, W) with the smallest
    exported batch that fits (padding with zero frames whose zero valid
    extents mask them out); a batch larger than every exported one runs in
    chunks. ``dispatches`` counts program calls. Runs on the card unless
    ``device="cpu"``."""

    def __init__(self, doc: Dict[str, Any], device="cuda"):
        # the ops' modules register the names the programs call
        import dgvcc_tpu_torch.ops.mem_attention  # noqa: F401
        import dgvcc_tpu_torch.ops.qconv  # noqa: F401
        from torch.export.passes import move_to_device_pass

        from dgvcc_tpu_torch.serve import resolve_device

        if doc.get("format") != AOT_FORMAT:
            raise ValueError(f"not a {AOT_FORMAT} artifact (format={doc.get('format')!r})")
        self.device = resolve_device(device)
        plats = [p.lower() for p in doc["platforms"]]
        if self.device.type not in plats:
            raise ValueError(f"artifact was lowered for {plats} but this counter's device is "
                             f"{self.device.type!r} — re-export with platforms="
                             f"{sorted(set(plats + [self.device.type]))}")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.bucket = int(doc["bucket"])
        self.quantized = True if doc.get("quantized") else None
        self.dispatches = {"fp": 0, "int8": 0}
        self._kind = "int8" if self.quantized else "fp"
        self._h2d = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # the live counter's layout: a model's 4-D weights channels-last on
        # the card (the graph follows its inputs' layout at run time)
        nhwc = self.device.type == "cuda" and not self.quantized
        self.weights = {
            k: (v.to(self.device, memory_format=torch.channels_last)
                if nhwc and v.dim() == 4 and v.is_floating_point()
                else v.to(self.device).contiguous())
            for k, v in doc["weights"].items()}
        self._programs: Dict[Tuple[int, int, int], Any] = {}
        self._by_hw: Dict[Tuple[int, int], List[int]] = {}
        for key, blob in doc["programs"].items():
            b, h, w = (int(x) for x in key.split("x"))
            ep = torch.export.load(io.BytesIO(zlib.decompress(blob)))
            module = move_to_device_pass(ep, self.device).module()
            # _resolve picks the program by shape and the weights are the
            # file's: skip the per-call check of every input, host time
            # spent before the first kernel
            module.validate_inputs = False
            self._programs[(b, h, w)] = module
            self._by_hw.setdefault((h, w), []).append(b)
        for sizes in self._by_hw.values():
            sizes.sort()

    @classmethod
    def load(cls, path: str, device="cuda") -> "AotCounter":
        return cls(read_aot(path), device=device)

    def _resolve(self, b: int, bh: int, bw: int) -> Tuple[int, Any]:
        sizes = self._by_hw.get((bh, bw))
        if not sizes:
            have = sorted(f"{bb}x{hh}x{ww}" for bb, hh, ww in self._programs)
            raise ValueError(f"no exported program for padded frame {bh}x{bw} "
                             f"(bucket={self.bucket}); artifact has: {have}")
        fit = next((s for s in sizes if s >= b), sizes[-1])
        return fit, self._programs[(fit, bh, bw)]

    def _launch(self, frames: np.ndarray):
        """(B, H, W, 3) uint8 -> [(pending counts, frames in it)], a chunk a
        program call."""
        from dgvcc_tpu_torch.serve import _Pending, upload

        b, h, w, c = frames.shape
        bh, bw = _padded_hw(h, w, self.bucket)
        bexp, prog = self._resolve(max(b, 1), bh, bw)
        out = []
        with torch.inference_mode():
            dev = upload(frames, self.device, self._h2d)
            for lo in range(0, b, bexp):
                n = min(bexp, b - lo)
                x = dev[lo:lo + n]
                if (n, h, w) != (bexp, bh, bw):
                    x = dev.new_zeros((bexp, bh, bw, c))
                    x[:n, :h, :w] = dev[lo:lo + n]
                valid = torch.zeros((bexp, 2), dtype=torch.int32, device=self.device)
                valid[:n, 0], valid[:n, 1] = h, w
                self.dispatches[self._kind] += 1
                out.append((_Pending(prog(self.weights, x, valid)), n))
        return out

    @staticmethod
    def _gather(pending) -> np.ndarray:
        return np.concatenate([p.result()[:n] for p, n in pending])

    def count_frames(self, frames: np.ndarray) -> np.ndarray:
        """frames: (B, H, W, 3) uint8 -> (B,) predicted counts."""
        return self._gather(self._launch(np.asarray(frames)))

    def stream(self, frame_batches: Iterable[np.ndarray],
               prefetch: int = 2) -> Iterator[np.ndarray]:
        """Pipelined streaming: ``prefetch`` batches in flight."""
        in_flight = collections.deque()
        for frames in frame_batches:
            in_flight.append(self._launch(np.asarray(frames)))
            if len(in_flight) > prefetch:
                yield self._gather(in_flight.popleft())
        while in_flight:
            yield self._gather(in_flight.popleft())
