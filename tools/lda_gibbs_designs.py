#!/usr/bin/env python3
"""Where the time of ``lda_gibbs``'s kernel goes, on one card.

    python3 tools/lda_gibbs_designs.py

Builds, in one process, the serial design of the Gibbs sweep
(``tools/lda_gibbs_serial.cu``: rows loaded after the previous token's
update, every logf after the decision, thread 0 updating between two
barriers) and the port's pipelined kernel
(``src/repro_torch/kernels/csrc/lda_gibbs.cu``) twice: as the port builds
it, and with ``-DLDA_GIBBS_DESIGNS -DLDA_GIBBS_STAMPS``, which adds the
variants below and per-block ``%globaltimer`` stamps.  Thread 0 (a
sampling thread) and the first noise thread sum the nanoseconds of each
phase of their loop over their block's tokens:

* sampling thread: its warp's best of the token (redux), the log refresh
  and the id pipeline ("ids ready"), the wait for the next token's rows
  ("rows ready"), the next token's logits ("logits done"), the barrier and
  the block's best ("argmax done"), the owners' update ("update done"), the
  copies of a later token's rows ("copies issued"), and the prologue;
* noise thread: the Philox Gumbel rows two tokens ahead and the row
  copies ("noise rows"), and the barrier.

A barrier's wait can surface in the phase after it (the warp blocks at
its next dependent instruction).  The variants are (block threads, ring
depth): 256 threads without a ring; 256 owners alone with 2 and 6 slots
(they draw the noise and copy their own columns); 256 owners and 256
noise threads with 4, 6, 8, 10 slots (the port's: 6); 128 owners and 256
noise threads; 512 and 512.

At the NYTimes shape of ``chip_smoke.py`` (128 workers, K = 1,000, round 0
of the planted corpus, Philox noise), each design runs from one copy of
the state: its first sweep from the planted start (the median of 3;
nearly every token changes topic, as in a rotation from the start), with
the stamps' medians over the blocks (µs a token, and the longest chain's
block); its bits against the serial design's; and the device time of
repeated calls (``chip_smoke.py::graph_ms``: round 0's draws repeat, so
after the first call almost no token changes).  Then the step of one
worker alone at K = 1 and K = 1,000 (20,000 tokens over 64 words).
Prints the card's name and power limit first.  Needs a card and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = 8
PHASES = ("warp best", "ids ready", "rows ready", "logits done",
          "argmax done", "update done", "copies issued", "prologue")
NOISE_PHASES = (("noise rows", 3), ("barrier", 4))
DESIGNS = [(256, 0), (256, 2), (256, 6), (512, 4), (512, 6), (512, 8),
           (512, 10), (384, 6), (1024, 6)]


def build(src, name, flags, _build):
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                        str(so), str(src)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll, ull = ctypes.c_longlong, ctypes.c_ulonglong
    tail = [i, i, p] if name != "serial" else [p]
    lib.lda_gibbs_launch.argtypes = [p] * 10 + [i] * 6 + [ll, i, i, i, f, f,
                                                          f, ull] + tail
    if hasattr(lib, "lda_gibbs_stamps"):
        lib.lda_gibbs_stamps.argtypes = [p, i]
    return lib, r.stdout + r.stderr


def launcher(torch, lib, args, kw, threads=None, depth=None):
    """A call of ``lib``'s launch on (words, docs, z, order, offsets, B, D,
    s); ``threads``/``depth`` None for the serial design."""
    words, docs, z, order, offsets, B, D, s = args
    P, T = words.shape
    K = B.shape[-1]
    st = torch.empty((P, K), device="cuda")
    n_blocks = offsets.shape[1] - 1

    def call():
        extra = () if threads is None else (threads, depth)
        err = lib.lda_gibbs_launch(
            words.data_ptr(), docs.data_ptr(), z.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), B.data_ptr(), D.data_ptr(), s.data_ptr(),
            st.data_ptr(), None, P, T, K, n_blocks, int(kw["rotate"]),
            kw["block_vocab"], B.shape[1] * K, D.shape[1], kw["phase"], 0,
            kw["vg"], kw["alpha"], kw["gamma"], kw["seed"], *extra,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return st
    return call


def first_sweep(torch, call, args, reps: int = 3) -> float:
    """ms of one call from the state ``args`` holds now, the planted start
    (z, B, D restored before each call and after the last): nearly every
    token changes topic, where the repeated calls of ``graph_ms`` change
    almost none (round 0's draws repeat)."""
    z, B, D = args[2], args[5], args[6]
    keep = z.clone(), B.clone(), D.clone()
    out = []
    for _ in range(reps):
        for t, k in zip((z, B, D), keep):
            t.copy_(k)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        call()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    for t, k in zip((z, B, D), keep):
        t.copy_(k)
    return sorted(out)[len(out) // 2]


def step_us(torch, cs, lib, K, threads=None, depth=None, tokens=20_000):
    """µs a token of one worker alone (one block on the card) at K."""
    from repro_torch.kernels import lda_gibbs as lg
    gen = torch.Generator(device="cuda").manual_seed(3)
    V, dpw = 64, 16
    words = torch.randint(0, V, (1, tokens), generator=gen, device="cuda",
                          dtype=torch.int32)
    docs = torch.randint(0, dpw, (1, tokens), generator=gen, device="cuda",
                         dtype=torch.int32)
    z = torch.randint(0, K, (1, tokens), generator=gen, device="cuda",
                      dtype=torch.int32)
    B, D, s = cs.lda_counts(torch, words, docs, z, 1, V, dpw, K)
    order, offsets = lg.gibbs_index(words, V, 1)
    kw = dict(phase=0, rotate=True, block_vocab=V, vg=V * 0.1, alpha=0.1,
              gamma=0.1, seed=cs.LDA_SEED)
    call = launcher(torch, lib, (words, docs, z, order, offsets, B, D, s),
                    kw, threads, depth)
    return cs.time_ms(torch, call, iters=5, warmup=1) * 1e3 / tokens


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.apps import lda
    from repro_torch.kernels import _build
    from repro_torch.kernels import lda_gibbs as lg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    serial, _ = build(os.path.join(ROOT, "tools", "lda_gibbs_serial.cu"),
                      "serial", [], _build)
    stamped, log = build(_build.CSRC / "lda_gibbs.cu", "lda_gibbs_designs",
                         ["-DLDA_GIBBS_DESIGNS", "-DLDA_GIBBS_STAMPS"],
                         _build)
    port = lg._lib()
    regs = cs.ptxas_kernels(log)
    print("registers and spills (stamped build): " + "; ".join(
        f"{k}: {v.get('registers')} regs, {v.get('spill_store_bytes')} B "
        f"spilled" for k, v in sorted(regs.items())))

    U, K = cs.LDA_WORKERS, cs.LDA_TOPICS
    cfg = lda.LDAConfig(vocab=cs.NYTIMES["vocab"], num_topics=K,
                        num_workers=U,
                        tokens_per_worker=cs.LDA_TOKENS_PER_WORKER,
                        docs_per_worker=cs.LDA_DOCS_PER_WORKER)
    words, docs, z0 = lda.synthetic_corpus_device(0, cfg, device="cuda")
    eng = lda.make_engine(cfg, device="cuda")
    data = eng.shard_data({"words": words, "docs": docs})
    init = eng.init_state(words=words, docs=docs, z0=z0)
    order, offsets = lg.gibbs_index(data["words"], cfg.block_vocab, U)
    counts = lg.active_counts(offsets, 0).long().cpu()
    longest = int(counts.argmax())
    print(f"NYTimes shape, round 0: {int(counts.sum())} active tokens, "
          f"longest chain {int(counts.max())} (worker {longest}), K = {K}, "
          f"ring depth {lg.ring_depth(K)}, {lg.block_threads(K)} threads")
    kw = dict(phase=0, rotate=True, block_vocab=cfg.block_vocab,
              vg=cfg.padded_vocab * cfg.gamma, alpha=cfg.alpha,
              gamma=cfg.gamma, seed=cs.LDA_SEED)

    def state():
        return (data["words"], data["docs"], init["z"].clone(), order,
                offsets, init["B"].clone(), init["D"].clone(), init["s"])

    want = state()
    want_s = launcher(torch, serial, want, kw)().clone()
    torch.cuda.synchronize()
    runs = [("serial", serial, None, None),
            ("port", port, 0, lg.ring_depth(K))] + [
        (f"{t} threads, {d} slots", stamped, t, d) for t, d in DESIGNS]
    for name, lib, threads, depth in runs:
        args = state()
        call = launcher(torch, lib, args, kw, threads, depth)
        first_ms = first_sweep(torch, call, args)
        line = f"{name:22s}: "
        if lib is stamped:             # the stamps of the last first sweep
            buf = (ctypes.c_ulonglong * (U * 2 * STAMPS))()
            lib.lda_gibbs_stamps(buf, U * 2 * STAMPS)
            per = [[buf[(b * 2 + who) * STAMPS + k] / 1e3 / max(1, int(n))
                    for k in range(STAMPS)]
                   for who in (0, 1) for b, n in enumerate(counts)]

            def med(rows, k):
                v = sorted(r[k] for r in rows)
                return v[len(v) // 2]
            own, noise = per[:U], per[U:]
            line += "µs a token of the first sweep (median block / longest " \
                "chain's): " + ", ".join(
                    f"{ph} {med(own, k):.3f}/{own[longest][k]:.3f}"
                    for k, ph in enumerate(PHASES[:7]))
            if threads > 256 and depth >= 4:
                line += "; noise thread: " + ", ".join(
                    f"{ph} {med(noise, k):.3f}" for ph, k in NOISE_PHASES)
            line += "; "
        s_t = call()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in
                   zip(args[2:3] + args[5:7], want[2:3] + want[5:7])) \
            and torch.equal(s_t, want_s)
        device_ms = cs.graph_ms(torch, call, calls=5, replays=4)
        print(f"{line}first sweep {first_ms:.3f} ms, repeated {device_ms:.3f}"
              f" ms, bits {'equal' if same else 'DIFFER'}", flush=True)
        del args, call
        torch.cuda.empty_cache()
    for name, lib, threads, depth in runs[:2]:
        print(f"{name}: one worker alone, µs a token: K = 1 "
              f"{step_us(torch, cs, lib, 1, threads, depth):.3f}, K = 1000 "
              f"{step_us(torch, cs, lib, 1000, threads, depth):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
