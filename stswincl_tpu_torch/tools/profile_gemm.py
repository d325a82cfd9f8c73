"""Device time of the Hopper GEMMs at the products of K1, K2, K5 and K6.

    python3 -m stswincl_tpu_torch.tools.profile_gemm [--reps 20]

Each form of `csrc/gemm_sm90.cu` alone (`ops.gemm`):
- at the serving batch (bs 2: 40960 token rows at C 512, 10240 at C
  1024), `linear_sm90` at K1's qkv (A gathered through the window
  partition, W-MSA and SW-MSA shift; and, for reference, A read straight
  by 2-D TMA), K1's proj (C scattered back to the image), K2's fc1 + GELU
  and fc2 + the fp32 residual;
- at the training batch (batch 8: 163840 rows at C 512, 40960 at C 1024),
  K5's input-gradient products (dattn, A
  gathered through the window partition; dx, C scattered through the
  shifted one) and weight gradients (`wgrad_sm90`: dwqkv with x gathered
  through the shifted partition, dwproj with g gathered), and K6's: at
  stage 1 (m recomputed, Pallas row 7) fc1 writing h and gelu', the m
  recompute and dh times that gelu', and the two ways to dpre and db1
  there, fc1 for h then the fused pair (fc1 twice) against gelu' through
  device memory; at stage 2 (m saved, row 9) the fused dh / pre pair
  (`gelu_bwd_sm90`, two products) against gelu' through device memory
  for the same h, dpre and db1; dn2 (fp32 out), dw1 and dw2.
Beside each, `torch.matmul` on the same bf16 operands (cuBLAS, no bias, no
row map, no epilogue: the yardstick; two calls for the fused pair), and
the plain twin. Mean ms over `--reps` back-to-back calls after three
warm-up calls (CUDA events), TFLOP/s and share of the H100's dense bf16
peak (989 TFLOP/s), the bound (the larger of the flops over that peak and
each operand read once, each output written once, over 3.35 TB/s); each
case is held within 1e-2 of its twin. The residual case adds into its out
tensor on every timed call, as K2 does once. Prints the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from stswincl_tpu_torch.ops import gemm

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, dense bf16; HBM3
SERVING = {"stage1": (512, 64, 80, 8), "stage2": (1024, 32, 40, 4)}
TRAIN_BATCH = 8  # clips; two-group layers fold to 2 * 8 images of 2 frames


def device_ms(fn, reps: int) -> float:
    """Mean ms of one call over `reps` back-to-back calls, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def products(C, h, w, ws, batch=2):
    """(name, M, N, K, keyword arguments) of K1's and K2's products."""
    M, grid = 2 * batch * 2 * h * w, (2, h, w, ws)
    return [("K1 qkv, W-MSA gather", M, 3 * C, C, dict(a_map=(*grid, 0))),
            ("K1 qkv, SW-MSA gather", M, 3 * C, C,
             dict(a_map=(*grid, ws // 2))),
            ("K1 qkv, A by 2-D TMA", M, 3 * C, C, {}),
            ("K1 proj, C scattered", M, C, C, dict(c_map=(*grid, 0))),
            ("K2 fc1 + GELU", M, 4 * C, C, dict(act="erf")),
            ("K2 fc2 + residual", M, C, 4 * C, dict(epi="resid_f32"))]


def train_products(C, h, w, ws):
    """(name, form, dims, keyword arguments) of K5's and K6's products at
    the training batch: dims (M, N, K) of a linear or the fused pair, (R,
    M, N) of a weight gradient."""
    R, grid = 2 * TRAIN_BATCH * 2 * h * w, (2, h, w, ws)
    win, win_shift = (*grid, 0), (*grid, ws // 2)
    out = [("K5 dattn, A gathered", "linear", (R, C, C), dict(a_map=win)),
           ("K5 dx, C scattered (shift)", "linear", (R, C, 3 * C),
            dict(c_map=win_shift)),
           ("K5 dwqkv, x gathered (shift)", "wgrad", (R, 3 * C, C),
            dict(b_map=win_shift)),
           ("K5 dwproj, g gathered", "wgrad", (R, C, C), dict(a_map=win))]
    if C == 512:  # stage 1 recomputes m (`mlp_output_saved`): row 7
        out += [("K6 fc1 + gelu' out", "linear", (R, 4 * C, C),
                 dict(act="erf", epi="gelu_grad")),
                ("K6 m recompute", "linear", (R, C, 4 * C), {}),
                ("K6 dh * gelu' in", "linear", (R, 4 * C, C),
                 dict(epi="dgelu")),
                # the two ways to dpre and db1 when m is recomputed
                ("K6 row 7 way: fc1 (h) + fused pair", "k6_way",
                 (R, 4 * C, C), dict(way="fused")),
                ("K6 row 7 way: fc1 + gelu' out, dh * gelu' in", "k6_way",
                 (R, 4 * C, C), dict(way="memory"))]
    else:  # row 9: m saved; the two ways to h, dpre and db1
        out += [("K6 fused dh / pre pair", "gelu_bwd", (R, 4 * C, C), {}),
                ("K6 row 9 way: fc1 + gelu' out, dh * gelu' in", "k6_way",
                 (R, 4 * C, C), dict(way="memory"))]
    out += [("K6 dn2 (fp32 out)", "linear", (R, C, 4 * C), dict(epi="f32")),
            ("K6 dw1", "wgrad", (R, 4 * C, C), {}),
            ("K6 dw2", "wgrad", (R, C, 4 * C), {})]
    return out


def _case(gen, dev, form, dims, kw, with_bias):
    """(kernel call, twin call, torch.matmul call, flops, bytes)."""
    bf = torch.bfloat16
    r = lambda *s, k=1.0: (torch.randn(s, generator=gen, device=dev)
                           * k).to(bf)
    if form == "wgrad":
        R, M, N = dims
        a, b = r(R, M), r(R, N)
        return (lambda: gemm.wgrad_sm90(a, b, **kw),
                lambda: gemm.wgrad_sm90_ref(a, b, **kw),
                lambda: torch.matmul(a.t(), b),
                2 * R * M * N, 2 * R * (M + N) + 4 * M * N)
    M, N, K = dims
    if form in ("gelu_bwd", "k6_way"):
        # dpre, db1 (and h) from n2, dm: the fused pair; fc1 once ahead for
        # h, then the fused pair (row 7's first way); or fc1 writing h and
        # gelu', then dh times that gelu' (through device memory)
        n2, dm = r(M, K), r(M, K)
        w1, w2_t = r(N, K, k=K ** -0.5), r(N, K, k=K ** -0.5)
        b1 = torch.randn(N, generator=gen, device=dev) * 0.1
        if form == "gelu_bwd":
            run = lambda: gemm.gelu_bwd_sm90(n2, dm, w1, w2_t, b1)
        elif kw["way"] == "fused":
            def run():
                gemm.linear_sm90(n2, w1, b1, "erf")
                dpre, _, db1 = gemm.gelu_bwd_sm90(n2, dm, w1, w2_t, b1,
                                                  with_h=False)
                return dpre, db1
        else:
            def run():
                h, d = gemm.linear_sm90(n2, w1, b1, "erf", epi="gelu_grad")
                dpre, db1 = gemm.linear_sm90(dm, w2_t, epi="dgelu", aux=d)
                return dpre, h, db1
        with_h = form == "gelu_bwd" or kw["way"] == "memory"
        twin = lambda: tuple(t for t in gemm.gelu_bwd_sm90_ref(
            n2, dm, w1, w2_t, b1, with_h=with_h) if t is not None)
        return (run, twin,
                lambda: (torch.matmul(n2, w1.t()), torch.matmul(dm, w2_t.t())),
                4 * M * N * K, 4 * M * K + 4 * N * K + 4 * M * N + 8 * N)
    a, wt = r(M, K), r(N, K, k=K ** -0.5)
    bias = (torch.randn(N, generator=gen, device=dev) * 0.1 if with_bias
            or kw.get("act", "none") != "none" else None)
    epi = kw.get("epi", "bf16")
    # bytes of the outputs (and of aux / out read) a row-column
    io = {"bf16": 2, "f32": 4, "resid_f32": 8, "gelu_grad": 6,
          "dgelu": 6}[epi]
    if epi in ("resid_f32", "f32"):
        kw = dict(kw, out=torch.randn((M, N), generator=gen, device=dev))
    if epi == "dgelu":  # gelu' of a unit normal: 0..1.13
        kw = dict(kw, aux=torch.rand((M, N), generator=gen, device=dev)
                  * 1.13)
    return (lambda: gemm.linear_sm90(a, wt, bias, **kw),
            lambda: gemm.linear_sm90_ref(a, wt, bias, **kw),
            lambda: torch.matmul(a, wt.t()),
            2 * M * N * K, 2 * (M * K + N * K) + io * M * N)


def _measure(name, form, run, twin, mm, flops, nbytes, reps):
    want = twin()  # first: the residual case adds into its out tensor
    got = run()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err, max_abs = 0.0, 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        d = g.float() - w.float()
        err = max(err, (d.norm() / w.float().norm()).item())
        max_abs = max(max_abs, d.abs().max().item())
    del got, want
    if err > 1e-2:
        raise RuntimeError(f"{name}: relative error {err}")
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {"case": name, "form": form, "rel_err": err,
           "max_abs_err": max_abs, "ms": device_ms(run, reps),
           "plain_ms": device_ms(twin, 1), "matmul_ms": device_ms(mm, reps),
           "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
           "bytes_ms": bytes_ms,
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print(f"  {name:58s} " + "  ".join(
        f"{label} {row[k]:.3f} ms {flops / row[k] / 1e9:4.0f} TFLOP/s "
        f"({flops / (row[k] * 1e-3) / PEAK_BF16:.1%})"
        for label, k in (("Hopper GEMM", "ms"),
                         ("torch.matmul", "matmul_ms")))
        + f"  bound {row['bound_ms']:.3f} ms", flush=True)
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gemm: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi} | {args.reps} calls a case", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, (C, h, w, ws) in SERVING.items():
        for name, M, N, K, kw in products(C, h, w, ws):
            rows.append(_measure(f"serve {tag} {name} ({M}, {N}, {K})",
                                 "linear", *_case(gen, dev, "linear",
                                                  (M, N, K), kw, True),
                                 args.reps))
            torch.cuda.empty_cache()
    for tag, (C, h, w, ws) in SERVING.items():
        for name, form, dims, kw in train_products(C, h, w, ws):
            rows.append(_measure(f"train {tag} {name} {dims}", form,
                                 *_case(gen, dev, form, dims, kw, False),
                                 args.reps))
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
