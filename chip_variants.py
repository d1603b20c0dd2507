#!/usr/bin/env python3
"""Kernel variants the port does not use, measured on one CUDA card (H100)
against the kept kernels, to find what bounds them.

    python3 chip_variants.py

1. K8a (``csrc/text_attention.cu``) at ``chip_smoke.py``'s three K8 shapes:
   the kept source with parts of its work taken out, each a copy with text
   replaced and built with the port's nvcc flags (timing only: their
   results are wrong; each one's error against the plain version is
   printed), and its two-pass form on mma.sync as before wgmma; SDPA with
   the same additive mask as the yardstick.  Each entry is timed twice, the
   list run forward and then backward.
2. K2's layer 1 with its A operand formed in registers
   (``csrc/variants/k2_register_a.cu``) against the kept code pass
   (``pair_int8_codes``) and smem-A GEMM (``pair_int8_layer``) on the first
   full chunk of the launch plan at full serving width, in turns; its codes
   are compared with the kept kernel's on the first and the last chunk.

Prints one JSON line a measurement (the builds' ptxas lines first), then
the card's name and power limit.  Times are CUDA events
(``chip_smoke.cuda_time_ms``).  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANT_DIR = os.path.join(ROOT, "protnote_tpu_torch", "csrc", "variants")

# text replaced in text_attention.cu: (old, new), each old found exactly once
SUBS = {
    # P.V's products: the probabilities summed into the output instead
    "pv_one_pass": ("        pv(kt, s[kt]);\n",
                    "        for (int j = 0; j < 8; ++j)\n"
                    "          for (int e = 0; e < 4; ++e) o[j][e] += s[kt][j][e];\n"),
    "pv_two_pass": ("          pv_wg(slot, s);\n",
                    "          for (int j = 0; j < 8; ++j)\n"
                    "            for (int e = 0; e < 4; ++e) o[j][e] += s[j][e];\n"),
    # the score products: a value made from Q in their place
    "score_one_pass": ("        ldsm_x4(bf, kbase + (key * LD + col) * 2);\n"
                       "        mma_bf16(s[2 * jp], qa[kk], bf[0], bf[1]);\n"
                       "        mma_bf16(s[2 * jp + 1], qa[kk], bf[2], bf[3]);\n",
                       "        (void)bf; (void)key; (void)col; (void)kbase;\n"
                       "        s[2 * jp][kk] += __uint_as_float(qa[kk][jp] & 0x3c7f0000u);\n"),
    "score_two_pass": ("      for (int kk = 0; kk < HD / 16; ++kk) wgmma_n64<0>(s, qa[kk], dk + 2 * kk, 1);\n",
                       "      (void)dk;\n"
                       "      for (int kk = 0; kk < HD / 16; ++kk)\n"
                       "        s[kk][kk] += __uint_as_float(qa[kk][kk] & 0x3c7f0000u);\n"),
    # expf and the division
    "exp_one_pass": ("            s[kt][j][e] = expf(__fsub_rn(s[kt][j][e], m[e >> 1]));\n",
                     "            s[kt][j][e] = __fsub_rn(s[kt][j][e], m[e >> 1]);\n"),
    "div_one_pass": ("            s[kt][j][e] = div_rn(s[kt][j][e], l[e >> 1], r[e >> 1]);\n",
                     "            s[kt][j][e] = __fmul_rn(s[kt][j][e], r[e >> 1]);\n"),
    "exp_rescale": ("            l[rr] = __fmul_rn(l[rr], expf(__fsub_rn(m[rr], mn)));\n",
                    "            l[rr] = __fmul_rn(l[rr], __fsub_rn(m[rr], mn));\n"),
    "exp_sum": ("              lt[e >> 1] = __fadd_rn(lt[e >> 1], expf(__fsub_rn(s[j][e], m[e >> 1])));\n",
                "              lt[e >> 1] = __fadd_rn(lt[e >> 1], __fsub_rn(s[j][e], m[e >> 1]));\n"),
    "div_two_pass": ("              s[j][e] = div_rn(expf(__fsub_rn(s[j][e], m[e >> 1])), l[e >> 1], r[e >> 1]);\n",
                     "              s[j][e] = __fmul_rn(__fsub_rn(s[j][e], m[e >> 1]), r[e >> 1]);\n"),
    # the K and V copies
    "kv_one_pass": ("      cp_async16(dst + (row * LD + col) * 2, src + base + (size_t)(ok ? key : 0) * HD + col, ok);\n",
                    "      (void)dst; (void)src; (void)ok; (void)row; (void)col; (void)key;\n"),
    "kv_two_pass": ("        cp_async16(dst + row * 128 + ((ck ^ (row & 7)) << 4),\n"
                    "                   src + base + (size_t)(ok ? key : 0) * HD + ck * 8, ok);\n",
                    "        (void)dst; (void)src; (void)ok; (void)row; (void)ck; (void)key;\n"),
    # the key mask's read (every key kept: no tile is skipped)
    "mask": ("    const bool kept = j < T && __ldg(mask_row + j) > 0;\n",
             "    const bool kept = j < T;\n"),
    # Q's read
    "q": ("      qa[kk][e] = r < T ? __ldg(reinterpret_cast<const uint32_t*>(q + base + (size_t)r * HD + col))\n"
          "                        : 0u;\n",
          "      qa[kk][e] = (uint32_t)(r * 131 + col * 7 + kk) & 0x3c3f3c3fu;\n"),
    # 64-query blocks
    "warps4": ("constexpr int WARPS = 8;", "constexpr int WARPS = 4;"),
    # the two-pass form on mma.sync: padded K/V tiles, per-warp tile ranges
    "mma_sync_loads": ("      load_sw(slot, 0, kt);\n      if (second) load_sw(slot, 1, kt);\n",
                       "      load_tile(slot, 0, kt);\n      if (second) load_tile(slot, 1, kt);\n"),
    "mma_sync_range": ("      if (kt >= glo && kt < ghi) {\n", "      if (kt >= lo && kt < hi) {\n"),
    "mma_sync_scores": ("        scores_wg(slot, kt, s);\n", "        scores(slot, kt, s);\n"),
    "mma_sync_pv": ("          pv_wg(slot, s);\n", "          pv(slot, s);\n"),
}
PV = ["pv_one_pass", "pv_two_pass"]
SCORE = ["score_one_pass", "score_two_pass"]
EXP_DIV = ["exp_one_pass", "div_one_pass", "exp_rescale", "exp_sum", "div_two_pass"]
KV = ["kv_one_pass", "kv_two_pass"]
K8A_VARIANTS = {
    "kept": [],
    "two_pass_mma_sync": ["mma_sync_loads", "mma_sync_range", "mma_sync_scores", "mma_sync_pv"],
    "no_pv_products": PV,
    "no_score_products": SCORE,
    "no_exp_div": EXP_DIV,
    "no_kv_loads": KV,
    "no_mask_read": ["mask"],
    "loads_and_stores_only": PV + SCORE + EXP_DIV,
    "compute_only": KV + ["mask", "q"],
    "64_query_blocks": ["warps4"],
}


def nvcc(src: str, out: str) -> str:
    """Build ``src`` into ``out`` with the port's flags; returns ptxas's
    register and spill lines."""
    from protnote_tpu_torch.ops import kernels

    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
                           "-o", out, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    return "\n".join(x.strip() for x in log.splitlines() if "registers" in x or "spill" in x)


def build(build_dir: str):
    """Every variant, one nvcc each, all at once: {name: (CDLL, ptxas)}."""
    from concurrent.futures import ThreadPoolExecutor

    from protnote_tpu_torch.ops import kernels

    base = (kernels.CSRC_DIR / "text_attention.cu").read_text()
    jobs = {}
    for name, subs in K8A_VARIANTS.items():
        text = base
        for s in subs:
            old, new = SUBS[s]
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: '{s}' matches {text.count(old)} times")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"text_attention_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libtext_attention_{name}.so"))
    jobs["k2_register_a"] = (os.path.join(VARIANT_DIR, "k2_register_a.cu"),
                             os.path.join(build_dir, "libk2_register_a.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    return {n: (ctypes.CDLL(j[1]), logs[n]) for n, j in jobs.items()}


def k8a_variants(libs, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from protnote_tpu_torch.ops import text_attention as k8a

    fns = {}
    for name in K8A_VARIANTS:
        fn = libs[name][0].masked_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    nh, hd = 16, 64
    gen = torch.Generator().manual_seed(30)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {}
    with torch.inference_mode():
        for shape, Bq, T, lo, hi, causal in cs.K8_SHAPES:
            _, mask = cs.token_batch(gen, Bq, T, lo, hi, 100, 1)
            q, k, v = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev, bf16) for _ in range(3))
            ctx = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), ctx.data_ptr(),
                         Bq, nh, T, hd, int(causal), k8a.scale_for(hd), stream)
                if err != 0:
                    raise RuntimeError(f"masked_attention launch failed: CUDA error {err}")

            keep = (mask > 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
            add_mask = torch.where(keep, 0.0, k8a.MASKED).to(bf16)
            want = k8a.masked_attention_reference(q, k, v, mask, causal).float()
            rel = {}
            for name, fn in fns.items():
                ctx.zero_()
                call(fn)
                rel[name] = float((ctx.float() - want).abs().max() / want.abs().max())
            run = {name: (lambda f: lambda: call(f))(fn) for name, fn in fns.items()}
            run["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add_mask)
            order = list(run)
            times = {name: [] for name in order}
            for sweep in (order, order[::-1]):
                for name in sweep:
                    times[name].append(cs.cuda_time_ms(run[name], 20))
            out[shape] = {"batch": Bq, "tokens": T, "causal": causal, "rel_err": rel,
                          "ms": {n: sum(t) / len(t) for n, t in times.items()},
                          "readings": times}
            cs.log("k8a_variants", shape=shape, **out[shape], card=card)
            del q, k, v, ctx, want, add_mask
    for name in ("kept", "two_pass_mma_sync"):
        if max(out[s]["rel_err"][name] for s in out) > cs.K8_REL_TOL:
            raise AssertionError(f"K8a variant {name} disagrees with the plain version")
    return out


def k2_register_a(libs, card: str) -> dict:
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import pair_scorer as ps

    lib = libs["k2_register_a"][0]
    fn = lib.pair_int8_layer1_rega
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 6 + [f] * 3 + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    lib.pair_int8_layer1_rega_smem_bytes.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    folded = cs.random_folded(gen, cs.D_LATENT, cs.H, 2, dev)
    P_e = torch.randn(cs.B, cs.D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(cs.NUM_LABELS * cs.K_DESCRIPTIONS, cs.D_LATENT,
                      generator=gen).to(dev, torch.bfloat16)
    out = {"smem_bytes": lib.pair_int8_layer1_rega_smem_bytes(), "chunks": {}}
    with torch.inference_mode(), torch.cuda.device(dev):
        q = ps.quantize_folded(folded, act_scales=ps.calibrate_act_scales(
            folded, P_e, L_e, cs.LABEL_TILE))
        k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
        s0 = float(q.act_scales[0])
        inv_in = float(ps._inv(q.act_scales[0], "cpu"))
        inv_next = float(ps._inv(q.act_scales[1], "cpu"))
        for which, ch in (("first", k.plan.chunks[0]), ("last", k.plan.chunks[-1])):
            rows = cs.B * ch.nl_pad
            codes = torch.zeros(rows, cs.H, dtype=torch.int8, device=dev)

            def register_a():
                err = fn(k.a.data_ptr(), k.c.data_ptr(), k.wt[0].data_ptr(), k.s_w[0].data_ptr(),
                         k.bias[0].data_ptr(), codes.data_ptr(), s0, inv_in, inv_next, cs.B,
                         ch.nl_pad, ch.l0, k.L, cs.H, cs.H, ch.grid, k.stream)
                if err != 0:
                    raise RuntimeError(f"pair_int8_layer1_rega launch failed: CUDA error {err}")

            k.quantize(ch, 0)
            k.layer(ch, 0, None)  # the next layer's codes into k.codes[1]
            register_a()
            differ = int((codes != k.codes[1][:rows]).sum())
            entry = {"rows": rows, "codes": rows * cs.H, "codes_differ": differ}
            if which == "first":
                run = {"kept_code_pass_and_gemm": lambda: (k.quantize(ch, 0), k.layer(ch, 0, None)),
                       "register_a": register_a,
                       "kept_code_pass": lambda: k.quantize(ch, 0),
                       "kept_gemm": lambda: k.layer(ch, 0, None)}
                order = list(run)
                times = {name: [] for name in order}
                for sweep in (order, order[::-1]):
                    for name in sweep:
                        times[name].append(cs.cuda_time_ms(run[name], 20))
                ms = {n: sum(t) / len(t) for n, t in times.items()}
                ops = 2.0 * rows * cs.H * cs.H
                entry.update(ms=ms, readings=times,
                             tops={n: ops / ms[n] / 1e9 for n in ("register_a", "kept_gemm")})
            out["chunks"][which] = entry
            cs.log("k2_register_a", chunk=which, **entry, card=card)
            if differ:
                raise AssertionError(f"K2's register-A layer 1: {differ} codes differ")
    return out


def main() -> None:
    import tempfile

    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("chip_variants.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = cs.card_line()
    with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
        libs = build(build_dir)
        cs.log("ptxas", **{n: log for n, (_, log) in libs.items()})
        k8a_variants(libs, card)
        k2_register_a(libs, card)
    print(card)


if __name__ == "__main__":
    main()
