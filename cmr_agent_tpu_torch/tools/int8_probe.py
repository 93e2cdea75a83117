"""int8 activation-storage probe for the 40960-point dense stacks (the JAX
package's ``tools/int8_probe.py``).

Times three storage strategies for the inter-layer ``[B, N, F]`` tensors of
a 9-layer Dense/LeakyReLU chain (raw_mlp(3) + point_mlp_0(3) +
point_mlp_1(3)):

  bf16    activations stored bf16;
  int8    activations quantised to int8 at the layer boundaries (a fixed
          symmetric scale of 1/16), matmuls still bf16: the effect of
          halving the stored bytes alone;
  int8mm  activations stored int8 and the matmul run int8 x int8 into
          int32 (``torch._int_mm``) with per-output-channel weight scales.

The projected episode gain scales the stacks' share of a bf16 serving
episode by each strategy's time. The share is read on the device the probe
runs on, from :mod:`.episode_trace`'s trace of the episode: the device time
of the kernels that the bf16 chain itself launches (by name; other calls of
the same kernels count too, so the share and the gain are upper bounds).
It is a ceiling probe: the fixed scale is calibration-free and accuracy is
not evaluated::

    python -m cmr_agent_tpu_torch.tools.int8_probe [--batch 8] [--iters 30]

Prints one JSON line; diagnostics on stderr. ``--device cpu`` rehearses it
at a small size (host times, no card).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from .. import serve
from ..utils.profiling import cuda_ms, profile_device

# activations after the LeakyReLU at this init sit in ~[-4, 4]; a 1/16
# quantum keeps clipping negligible for the probe
ACT_S = 16.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chain_params(rng: np.random.Generator, layers: int, f_in: int,
                 f_out: int):
    """The JAX probe's weights and biases (float64 numpy, in its draw
    order)."""
    ws, bs = [], []
    fi = f_in
    for _ in range(layers):
        ws.append(rng.normal(size=(fi, f_out), scale=fi ** -0.5))
        bs.append(rng.normal(size=(f_out,), scale=0.01))
        fi = f_out
    return ws, bs


def _leaky(x: torch.Tensor) -> torch.Tensor:
    # the slope rounded to the operand's dtype, as JAX's weak-typed 0.2
    return torch.where(x > 0, x, x * torch.tensor(0.2, dtype=x.dtype,
                                                  device=x.device))


def q8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() * ACT_S), -127,
                       127).to(torch.int8)


def dq8(x8: torch.Tensor) -> torch.Tensor:
    return (x8.float() * (1.0 / ACT_S)).to(torch.bfloat16)


def build_fns(batch: int, n: int, f: int, layers: int, device="cuda"):
    """``(x0, {"bf16", "int8", "int8mm": fn(x, shift)})``: the input
    (bf16) and the three chains, from the JAX probe's seed-0 numpy draws."""
    dev = serve.resolve_device(device)
    rng = np.random.default_rng(0)
    ws_np, bs_np = chain_params(rng, layers, f, f)
    x_np = rng.normal(size=(batch, n, f)).astype(np.float32)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        dev, torch.bfloat16)
    ws, bs, x0 = [bf(w) for w in ws_np], [bf(b) for b in bs_np], bf(x_np)

    def fwd_bf16(x, shift):
        x = x + shift.to(x.dtype)
        for w, b in zip(ws, bs):
            x = _leaky(x @ w + b)
        return x

    def fwd_int8_store(x, shift):
        x = x + shift.to(x.dtype)
        x8 = q8(x)
        for w, b in zip(ws, bs):
            x8 = q8(_leaky(dq8(x8) @ w + b))   # the stored tensor is int8
        return dq8(x8)

    w8s = []
    for w in ws_np:
        s = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
        w8s.append((torch.from_numpy(np.round(w / s).astype(np.int8)).to(dev),
                    torch.from_numpy(s.astype(np.float32)).to(dev)))

    def fwd_int8_mm(x, shift):
        x = x + shift.to(x.dtype)
        x8 = q8(x)
        for (w8, s), b in zip(w8s, bs):
            acc = torch._int_mm(x8.reshape(-1, x8.shape[-1]), w8)
            y = acc.reshape(x8.shape[:-1] + (-1,)).float() * (s / ACT_S)
            x8 = q8(_leaky(y.to(torch.bfloat16) + b))
        return dq8(x8)

    return x0, {"bf16": fwd_bf16, "int8": fwd_int8_store,
                "int8mm": fwd_int8_mm}


def time_fn(fn, x, iters: int) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU; the
    output feeds the next call's input shift, as the JAX probe chains
    them."""
    shift = torch.zeros((), device=x.device)

    def step():
        nonlocal shift
        shift = fn(x, shift).float().mean() * 1e-12

    if x.is_cuda:
        return cuda_ms(step, iters)
    step()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    return (time.perf_counter() - t0) / iters * 1e3


def stack_share(chain, x, args, dev) -> dict:
    """The stacks' ms in one bf16 serving episode: the trace's device
    time (host-op self time on the CPU) in the kernels the chain launches,
    and the episode's whole time."""
    from . import episode_trace
    zero = torch.zeros((), device=dev)
    # ten calls: the profiler can miss every device row of a short window
    chain_rows, _ = profile_device(lambda: chain(x, zero), dev.type, 10)
    with contextlib.redirect_stdout(sys.stderr):
        trace = episode_trace.main([
            "--batch", str(args.episode_batch), "--iters",
            str(args.episode_iters), "--dtype", "bfloat16", "--config",
            args.config, "--device", str(dev), "--top", "100000"])
    rows = trace["top"]
    total = sum(r["per_iter_ms"] for r in rows)
    stack = sum(r["per_iter_ms"] for r in rows if r["op"] in
                {op[:120] for op in chain_rows})
    return {"episode_ms": total, "stack_ms": stack,
            "kernels": sorted(op[:120] for op in chain_rows)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=40960)
    p.add_argument("--f", type=int, default=64)
    p.add_argument("--layers", type=int, default=9,
                   help="Dense/BN/LReLU layers at N points: raw_mlp(3) + "
                        "point_mlp_0(3) + point_mlp_1(3)")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--config", default="kitti",
                   choices=("kitti", "tiny", "micro"),
                   help="the traced episode's width")
    p.add_argument("--episode-batch", type=int, default=8)
    p.add_argument("--episode-iters", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for a rehearsal")
    args = p.parse_args(argv)

    dev = serve.resolve_device(args.device)
    x, fns = build_fns(args.batch, args.n, args.f, args.layers, dev)
    on_card = dev.type == "cuda"
    log(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}; "
        f"x {tuple(x.shape)} {x.dtype}; {args.layers} layers")
    ms = {}
    with torch.no_grad():
        for name, fn in fns.items():
            ms[name] = time_fn(fn, x, args.iters)
            log(f"{name:7s} {ms[name]:8.3f} ms/iter")
        share = stack_share(fns["bf16"], x, args, dev)
    ep, st = share["episode_ms"], share["stack_ms"]
    log(f"episode {ep:.3f} ms, of which the chain's kernels {st:.3f} ms")
    proj = {name: ep / (ep - st + st * ms[name] / ms["bf16"])
            for name in ("int8", "int8mm")}
    result = {
        "bf16_ms": ms["bf16"], "int8_ms": ms["int8"],
        "int8mm_ms": ms["int8mm"],
        "int8_speedup": ms["bf16"] / ms["int8"],
        "int8mm_speedup": ms["bf16"] / ms["int8mm"],
        "episode_ms": ep, "stack_ms": st,
        "stack_share": st / ep if ep else None,
        "projected_episode_gain_int8": proj["int8"],
        "projected_episode_gain_int8mm": proj["int8mm"],
        "stack_kernels": share["kernels"],
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
