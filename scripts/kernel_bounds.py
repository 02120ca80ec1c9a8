#!/usr/bin/env python3
"""Least time an H100 could take for each TPU kernel of the repo.

For every ``pl.pallas_call`` of the JAX package, at the shapes of the
path that runs it: the operations it must do over the card's dense peak
for their type, and the bytes it must move (each input read once, each
output written once) over HBM bandwidth; the bound is the larger. Pure
arithmetic, no GPU needed:

    python3 scripts/kernel_bounds.py
"""

PEAK = {"bf16": 989e12, "f32": 67e12}   # H100 SXM dense FLOP/s (tensor cores, CUDA cores)
HBM = 3.35e12                           # H100 SXM bytes/s


def row(name, flops, kind, nbytes, l2_bytes=None):
    t_ops, t_bytes = 1e3 * flops / PEAK[kind], 1e3 * nbytes / HBM
    by = "operations" if t_ops >= t_bytes else "bytes"
    l2 = "" if l2_bytes is None else f" | L2->SM {l2_bytes / 1e9:.4g} GB"
    print(f"{name:<58} {flops / 1e9:9.4g} GFLOP ({kind}) {t_ops:8.4f} ms | "
          f"{nbytes / 1e6:8.1f} MB {t_bytes:8.4f} ms | bound {max(t_ops, t_bytes):.4f} ms "
          f"({by}){l2}")


def main():
    K, S = 256, 1024
    for b in (1, 4, 16):  # serving: 768x1024 frame -> P = 192 * 256
        p = 192 * 256
        row(f"#1 memory_attention_fused serve B={b} P={p}",
            4.0 * b * p * K * S, "bf16", 2.0 * (2 * b * p * K + K * S))
    # the work the port's designs of #1 (csrc/mem_attention.cu) do for the
    # same function, and the bank bytes each block streams from L2 into
    # shared memory (every block reads all of M; HBM bytes, and so the
    # bound, unchanged): the first design, on mma.sync, splits p into bf16
    # hi + lo and runs p . M^T twice (3 products) in blocks of 64 rows; the
    # wgmma design rounds p to bf16 once (2 products) in tiles of 128 rows
    for b in (1, 4):
        p = 192 * 256
        for design, products, tile in (("mma.sync, 3 products, 64-row", 3, 64),
                                       ("wgmma, 2 products, 128-row", 2, 128)):
            row(f"#1 as ported ({design}) B={b}", 2.0 * products * b * p * K * S, "bf16",
                2.0 * (2 * b * p * K + K * S), -(-b * p // tile) * 2.0 * K * S)
    b, p = 16, 80 * 80  # training: 320^2 crops at stride 4, two views
    row(f"#2 memory_attention_train fwd B={b} P={p} x2 views",
        2 * 4.0 * b * p * K * S, "bf16",
        2.0 * (4 * b * p * K + K * S) + 4)
    # backward recomputes the logits and forms dp, dy and dM (two products)
    # for each view: 10 products of P*K*S multiply-adds in all
    row(f"#3 memory_attention_train bwd B={b} P={p} x2 views",
        2 * 10.0 * b * p * K * S, "bf16",
        2.0 * (6 * b * p * K + K * S) + 4.0 * K * S)
    # the work the port's kernels (csrc/mem_attention_train.cu) do for the
    # same function. The first forward, on mma.sync, computed the logits twice
    # for a two-sweep softmax (6 products) in blocks of 64 rows of both
    # views; the backward recomputes logits and dout . M in both its row and
    # its column kernel and sweeps S once more for D (18 products). The last
    # column: the bank bytes every block streams from L2 per row tile
    m_bytes = 2.0 * K * S
    row(f"#2 first port (mma.sync, 6 products) B={b} P={p} x2 views",
        2 * 6.0 * b * p * K * S, "bf16", 2.0 * (4 * b * p * K + K * S) + 4,
        -(-b * p // 64) * 2 * m_bytes)
    # the redesign (wgmma, TMA): one sweep with an online softmax (4
    # products, the TPU kernel's count); it also writes lse and q (5 f32 a
    # row) and one loss term per 32 rows; each persistent block streams all
    # of M once per 64-row tile of both views
    row(f"#2 as redesigned (4 products) B={b} P={p} x2 views",
        2 * 4.0 * b * p * K * S, "bf16",
        2.0 * (4 * b * p * K + K * S) + 4.0 * 5 * b * p + 4.0 * -(-b * p // 32) + 4,
        -(-b * p // 64) * m_bytes)
    row(f"#3 as ported (18 products) B={b} P={p} x2 views",
        2 * 18.0 * b * p * K * S, "bf16",
        2.0 * (6 * b * p * K + K * S) + 4.0 * K * S)
    # the redesign (wgmma): D from the forward (<dout, out>_K and the q
    # sums), so no sweep for D: rows kernel logits, dout . M and dy (3
    # products a view), cols kernel logits, dout . M and both dM products
    # (4): 14 products; it also reads out1, out2 and the forward's lse and q
    row(f"#3 as redesigned (14 products) B={b} P={p} x2 views",
        2 * 14.0 * b * p * K * S, "bf16",
        2.0 * (8 * b * p * K + K * S) + 4.0 * K * S + 4.0 * 5 * b * p)
    # #4 at the shapes chip_smoke.py and scripts/sweep_dmap.py time it: S1 a
    # ShanghaiTech B frame, S2 JHU-Crowd++'s densest image (25,791 heads) at
    # preprocess.py's 2048 px short side, S3 a sparse image of that size; r = 7
    r, tile = 7, 32
    for name, h, w, n in (("S1", 768, 1024, 1024), ("S2", 2048, 3072, 25000),
                          ("S3", 2048, 3072, 1000)):
        tiles = -(-h // tile) * -(-w // tile)
        row(f"#4 gaussian_density_pallas {name} {h}x{w} N={n} (dense)",
            2.0 * h * w * n, "f32", 4.0 * (h * w + 3 * n))
        # the function: the map written once, the points (x, y f32 and a mask
        # byte) read once, one multiply-add per pixel of each point's
        # (2r+1)^2 window (unclipped here; chip_smoke.py clips it to the image
        # for its points); the bytes bound it
        flops, nbytes = 2.0 * (2 * r + 1) ** 2 * n, 4.0 * h * w + 9.0 * n
        row(f"#4 {name} sparse: the function", flops, "f32", nbytes)
        # the first port's design: the same HBM bytes; each of the tiles'
        # blocks reads all n points (from L2)
        row(f"#4 {name} first port, {tiles} blocks x N", flops, "f32", nbytes,
            tiles * 9.0 * n)
        # the binned design (csrc/dmap.cu): the points read twice (count,
        # scatter), the binned list (index, packed x y: 8 bytes a point)
        # written once and read once, each tile's count and end written and
        # read, the map written once; each splat block reads the segments of
        # the 9 tiles around it (from L2)
        row(f"#4 {name} as redesigned (binned)", flops, "f32",
            4.0 * h * w + 2 * 9.0 * n + 2 * 8.0 * n + 4 * 4.0 * tiles, 9 * 8.0 * n)

if __name__ == "__main__":
    main()
