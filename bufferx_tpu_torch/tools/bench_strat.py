"""Kernel K2 (the stratified query) on the card: edge shapes and times.

    python3 -m bufferx_tpu_torch.tools.bench_strat

Builds ``csrc/strat.cu`` alone, holds the kernel against its plain version
(bit-exact) on seeded edge shapes chosen against its design, and times it at
the serving path's shapes on seeded random inputs: one cloud, one pair
(C = 2) and a batch of 8 pairs (C = 16), for all three radii and for phase
1's single radius, each beside the bytes it must move and the rate that makes. A launch is
timed alone between two CUDA events, which also brackets the wrapper's host
work, and as ten launches back to back, which hides it. ``chip_smoke.py``
uses the same edge shapes and timers on a real pair's inputs, beside the
bound those bytes set. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from bufferx_tpu_torch.kernels import strat_pallas

# (label, clouds, centres, strips L, slots S, radii R, rows of the matrix a
# cloud's d2 is a view of): tiles are 64 slots wide, 8-byte loads need
# S % 4 == 0
EDGE_SHAPES = [
    ("C = 1, S = 64 (one tile)", 1, 96, 32, 64, 3, 96),
    ("C = 2, R = 1", 2, 40, 9, 128, 1, 40),
    ("C = 5, S = 36 (ragged tile)", 5, 7, 5, 36, 2, 7),
    ("S = 200 (full tiles and a ragged one), L = 1, R = 4", 2, 3, 1, 200, 4,
     3),
    ("L = 127, S = 6 (4-byte loads)", 1, 5, 127, 6, 3, 5),
    ("L = 127, S = 256", 2, 9, 127, 256, 2, 9),
    ("S = 130 (4-byte loads), K = 1", 2, 1, 59, 130, 3, 1),
    ("S = 131 (odd)", 3, 4, 17, 131, 2, 4),
    ("K = 1 of a larger matrix", 6, 1, 59, 512, 3, 4),
    ("more blocks than units", 1, 2, 59, 512, 1, 2),
    ("C = 3, K = 301 (a redo batch's odd sizes)", 3, 301, 59, 512, 3, 400),
    ("C = 10, K = 1500 of 2000, R = 3", 10, 1500, 59, 512, 3, 2000),
]


def make_case(seed: int, c_n: int, kq: int, l: int, s: int, num_r: int,
              rows: int, device):
    """Seeded kernel inputs, made on ``device``: d2 (a [C, K, N] view of a
    [C, rows, N] matrix) with masked (1e30) and exact-radius entries, q,
    offsets, squared radii whose hit rates leave slots with and without a
    hit."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    d2 = rand(c_n, rows, l * s)
    d2.masked_fill_(rand(c_n, rows, l * s) < 0.1, 1e30)
    radii2 = torch.sort(torch.clamp_max((0.2 + 2.8 * rand(c_n, num_r)) / l,
                                        0.6), dim=1, descending=True).values
    d2 = torch.where(rand(c_n, rows, l * s) < 0.02, radii2[:, :1, None], d2)
    q_t = torch.randint(0, 1 << 24, (c_n, 3, l, s), generator=gen,
                        device=device, dtype=torch.int32)
    off = torch.randint(0, l, (c_n, kq, s), generator=gen, device=device,
                        dtype=torch.int32)
    return d2[:, :kq], q_t, off, radii2.contiguous()


def check_edges(log=print) -> int:
    """The kernel bit-exact against the plain version on every edge shape;
    raises otherwise. Returns the number of shapes."""
    for i, (label, c_n, kq, l, s, num_r, rows) in enumerate(EDGE_SHAPES):
        args = make_case(17 + i, c_n, kq, l, s, num_r, rows, "cuda")
        want = strat_pallas.strat_packed_plain(*args)
        got = strat_pallas.strat_packed_cuda(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"strat, {label}: {int((got != want).sum())} packed words "
                "differ from the plain version")
        log(f"strat, {label}: d2 {list(args[0].shape)} of {rows} rows, L = "
            f"{l}, R = {num_r}: bit-exact")
    return len(EDGE_SHAPES)


def strat_bytes(d2, q_t, off, radii2) -> int:
    """What the function must move: every input once, the output once."""
    c_n, kq, _n = d2.shape
    out = c_n * radii2.shape[1] * 3 * kq * off.shape[2]
    return 4 * (d2.numel() + q_t.numel() + off.numel() + radii2.numel() + out)


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_back_to_back_ms(fn, reps: int = 5, launches: int = 10) -> float:
    """Per launch, ``launches`` of ``fn`` between one pair of events: the
    card works on one while the host queues the next, so the wrapper's host
    time is hidden as long as it is the shorter."""
    return time_ms(lambda: [fn() for _ in range(launches)], reps) / launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_strat needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kernel = strat_pallas.STRAT_KERNEL
    kernel.lib()
    for line in kernel.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip(), flush=True)
    check_edges(lambda *a: print(*a, flush=True))
    rows = []
    for c_n in (1, 2, 16):
        for num_r in (3, 1):
            args = make_case(3, c_n, 1500, 59, 512, num_r, 2000, "cuda")
            nbytes = strat_bytes(*args)

            def fn():
                return strat_pallas.strat_packed_cuda(*args)
            ms, ms10 = time_ms(fn, 20), time_back_to_back_ms(fn)
            rows.append(dict(clouds=c_n, radii=num_r, ms=ms,
                             ms_back_to_back=ms10, bytes=nbytes))
            print(f"C = {c_n:2d}, R = {num_r}: {ms:.4f} ms a launch alone, "
                  f"{ms10:.4f} ms back to back, {nbytes / 1e6:.1f} MB "
                  f"({nbytes / ms10 / 1e9:.2f} TB/s)", flush=True)
            del args
    print("RESULT " + json.dumps({
        "device": torch.cuda.get_device_name(0), "smi": smi,
        "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
