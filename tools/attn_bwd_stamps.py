#!/usr/bin/env python3
"""Where the time of the flash-attention backward's wgmma kernels goes.

    python3 tools/attn_bwd_stamps.py [--seed 0]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` a second time
with ``-DFA_BWD_STAMPS``: lane 0 of every consumer warp of
``flash_bwd_dkdv_wgmma`` and ``flash_bwd_dq_wgmma`` sums the ``clock64``
cycles of each phase of its loop over its block's steps (a step: one q
tile of 64 rows for dK/dV, one kv tile of 64 keys for dQ):

    full wait   the stage's full barrier (the producer's TMA copies)
    turn wait   the other warpgroup's turn (named barrier)
    issue       S^T and dP^T (dQ: S and dP) issued
    S landed    wgmma.wait_group 1
    P           the exponentials and the packing (dK/dV: and dV issued)
    dP landed   wgmma.wait_group (dK/dV: 1, dQ: 0)
    dS          dS and its packing, and dK (dQ: dQ) issued
    drain       wgmma.wait_group 0
    loop        the empty barrier's arrival, the step's bookkeeping, and
                the steps whose slab sees no pair

At MiniCPM-2B's training call (4, 2048, 48, 64) bf16 causal it prints,
for each kernel, the mean cycles a step of each phase over all consumer
warps, their sum, and the device ms of the stamped and the port's build
(the stamps' cost).  A phase that waits can surface in the next one (a
warp blocks at its first dependent instruction).  Prints the card's name
and power limit first and one JSON line last.  Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("full wait", "turn wait", "issue", "S landed", "P", "dP landed",
          "dS", "drain", "loop")
BLOCKS, WARPS = 4096, 16
SHAPE = (4, 2048, 48, 64)              # B, S, H, D


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attn_bwd_stamps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from attn_bwd_turns import graph_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libflash_attention_stamps.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DFA_BWD_STAMPS", "-o",
         str(so), str(_build.CSRC / "flash_attention.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    stamped = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    stamped.flash_attention_bwd_launch.argtypes = [p] * 11 + [i] * 9 + [
        p, i, i, ctypes.c_float, p]
    stamped.flash_attention_bwd_stamps.argtypes = [p, ctypes.c_longlong]

    B, S, H, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v, dout = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                     .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    route = tfa.bwd_route(q, k, v, o, dout)
    rows = tfa.bwd_rows(S, route)

    def empty():
        return torch.empty((B, S, H, D), dtype=q.dtype,
                           device="cuda").transpose(1, 2)
    dq, dk, dv = empty(), empty(), empty()
    delta = torch.empty((B, H, rows), dtype=torch.float32, device="cuda")
    lse2 = torch.empty_like(delta)
    st = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, dout, dq, dk, dv) for s in x.stride()[:3]))

    def run_stamped():
        err = stamped.flash_attention_bwd_launch(
            *(x.data_ptr() for x in (q, k, v, o, dout, lse, delta, lse2, dq,
                                     dk, dv)),
            1, tfa.BWD_ROUTES.index(route), B, H, H, S, S, D, rows, st, 1, 0,
            D ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stamped backward: CUDA error {err}")

    run_stamped()
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd(q, k, v, o, lse, dout)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    n = 2 * BLOCKS * WARPS * (len(PHASES) + 1)
    buf = torch.zeros(n, dtype=torch.int64)
    err = stamped.flash_attention_bwd_stamps(buf.data_ptr(), n)
    if err:
        raise RuntimeError(f"reading the stamps: CUDA error {err}")
    buf = buf.view(2, BLOCKS, WARPS, len(PHASES) + 1)
    res = {"card": smi, "shape": list(SHAPE), "route": route,
           "stamped_equals_port": same,
           "stamped_device_ms": graph_ms(torch, run_stamped),
           "port_device_ms": graph_ms(torch, lambda: tfa.flash_attention_bwd(
               q, k, v, o, lse, dout))}
    for kern, name in enumerate(("dkdv", "dq")):
        x = buf[kern].reshape(-1, len(PHASES) + 1).double()
        steps = x[:, -1].sum().item()
        per = {ph: x[:, j].sum().item() / steps for j, ph in
               enumerate(PHASES)}
        res[name] = {"steps": steps, "cycles_a_step": per,
                     "sum": sum(per.values())}
        print(f"{name}: " + ", ".join(f"{ph} {c:.0f}" for ph, c in
                                      per.items())
              + f"; sum {sum(per.values()):.0f} cycles a step")
    print(json.dumps(res))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
