"""``quantize`` and ``unpack`` at the main path's shapes, on the inputs that
set their time.

``quantize`` runs on ``--quant-n`` float32 values (GraphCast's owned chunk
on the 2x2 grid: 11,264 rows x 512), random, and the same values with the
last ``--zero-tail`` zero (the last rank's chunk, whose 4,094 padding rows
are zero: 36% of it; a zero numerator is what the kernel's division has to
steer round).  ``unpack_planes`` runs on ``--planes`` x ``--unpack-words``
words at b = 1 (a rank's column bitmaps on the 2x2 grid) and on the b = 16
id stream of ``chip_smoke.py`` ((8, 8,192) words).  Each is first held
against its plain version exactly, then timed: "card" is CUDA events over
``--reps`` wrapper calls (the host floor included), "device" the profiler's
kernel time a call.  Prints the card (``nvidia-smi`` name and power limit),
a line a case and one JSON object (microseconds).

    python -m repro_torch.bench.kernel_sweep [--reps 200]
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import kernels
from repro_torch.bench import card, mean_us
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.bitpack import ref as bp_ref
from repro_torch.kernels.quant import ops as q_ops
from repro_torch.kernels.quant import ref as q_ref
from repro_torch.launch.roofline import HBM_BW


def case(fn, nbytes: int, reps: int) -> dict:
    return {"card_us": mean_us(fn, reps, "cuda"),
            "device_us": kernels.device_ms(fn, reps)[0] * 1e3,
            "bound_us": nbytes / HBM_BW * 1e6}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant-n", type=int, default=5_767_168)
    ap.add_argument("--zero-tail", type=int, default=4_094 * 512)
    ap.add_argument("--planes", type=int, default=8)
    ap.add_argument("--unpack-words", type=int, default=65_536)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: times the CUDA kernels and needs a card")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(args.quant_n, generator=gen, device="cuda")
    n = x.numel()
    padded = x.clone()
    padded[n - args.zero_tail:] = 0
    cases = {}
    for name, values in (("random", x), (f"last {args.zero_tail} zero", padded)):
        if not all(map(torch.equal, q_ops.quantize(values), q_ref.quantize(values))):
            raise AssertionError(f"quantize on {name} values differs from the plain version")
        cases[f"quantize {name}"] = case(lambda: q_ops.quantize(values),
                                         4 * n + n + 4 * (n // q_ref.GROUP), args.reps)
    bitmaps = torch.randint(-2**31, 2**31 - 1, (args.planes, args.unpack_words), generator=gen,
                            device="cuda", dtype=torch.int64).to(torch.int32)
    ids = torch.randint(0, 2**16, (args.planes, 8192), generator=gen, device="cuda",
                        dtype=torch.int32)
    for b, words in ((1, bitmaps), (16, ids)):
        if not torch.equal(bp_ops.unpack_planes(words, b), bp_ref.unpack_planes(words, b)):
            raise AssertionError(f"unpack at b={b} differs from the plain version")
        out_bytes = words.numel() * 32 // b * (1 if b == 1 else 4)
        cases[f"unpack b={b} {tuple(words.shape)}"] = case(
            lambda: bp_ops.unpack_planes(words, b), words.numel() * 4 + out_bytes, args.reps)
    summary = {"card": card(), "reps": args.reps, "quant_n": n, "cases": cases}
    print(f"card: {summary['card']}")
    for name, c in cases.items():
        print(f"{name}: card {c['card_us']:.3f} us, device {c['device_us']:.3f} us, "
              f"bound {c['bound_us']:.3f} us (bytes)")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
