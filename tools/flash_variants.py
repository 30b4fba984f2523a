#!/usr/bin/env python
"""Time kernel A of the PyTorch port (flash attention, CUDA) on one
NVIDIA card: its forward as committed against variants built from
edited copies of ``src/repro_torch/csrc/flash_attn_fwd.cu``, and its
backward, each beside SDPA, all in one process so that they compare on
one card:

    python tools/flash_variants.py

Variants of the forward:
  * ``one-P``: P enters P·V rounded once to bf16 (no hi + lo pair);
  * ``8-warps``: 8 warps of 16 rows, 128 query rows a block (head_dim
    64 and 128 only: 80 does not split its tiles over 256 threads).
Each row prints the max abs error against the plain version and the
device time of one call (``chip_smoke.time_ms``: CUDA events, cold L2).
"""
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

# (B, S, H, KV, D), causal: gpt2m training and prefill, zamba2, llama3.2
SHAPES = ((8, 1024, 16, 16, 64), (8, 64, 16, 16, 64), (1, 256, 16, 16, 64),
          (8, 64, 32, 32, 80), (8, 64, 24, 8, 128), (1, 257, 24, 8, 128),
          (8, 1024, 24, 8, 128))
BWD_SHAPES = ((8, 1024, 16, 16, 64), (1, 256, 32, 32, 80))


def variants(src: str):
    """name -> (source text, head dims it is built for)."""
    def edit(text, old, new):
        if old not in text:
            raise SystemExit(f"flash_attn_fwd.cu changed: no {old!r}")
        return text.replace(old, new)

    one_p = edit(src, "c_to_a_split(pa, pl, s[2 * kk], s[2 * kk + 1]);",
                 "c_to_a(pa, s[2 * kk], s[2 * kk + 1]);")
    one_p = edit(one_p, "          mma_bf16(acc[2 * dp], pl, bfr[0], bfr[1]);\n"
                        "          mma_bf16(acc[2 * dp + 1], pl, bfr[2], "
                        "bfr[3]);\n", "")
    warps8 = edit(src, "constexpr int FWD_BQ = 64; ",
                  "constexpr int FWD_BQ = 128;")
    warps8 = edit(warps8, "constexpr int FWD_NT = 128;",
                  "constexpr int FWD_NT = 256;")
    warps8 = edit(warps8, "  FLASH_LAUNCH(80, 80)\n", "")
    return {"committed": (src, (64, 80, 128)), "one-P": (one_p, (64, 80, 128)),
            "8-warps": (warps8, (64, 128))}


def build(name, text, out_dir, build_mod):
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"{name}.so")
    r = subprocess.run([build_mod.nvcc_path(), *build_mod.ARCH_FLAGS,
                        *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC),
                        "-o", lib, path], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(lib).flash_attn_fwd_bf16
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P] + [I] * 7 + [L] * 12 + [
        ctypes.c_float, I, I, P, P, P]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs an NVIDIA card")
    import torch.nn.functional as F

    from chip_smoke import card_line, time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    print(card_line(), flush=True)
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: (build(name, text, tmp, _build), dims)
                for name, (text, dims) in variants(src).items()}

        def run(fn, q, k, v):
            B, Sq, H, D = q.shape
            o = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, H, k.shape[2], Sq, k.shape[1], D, D, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                     D ** -0.5, 1, 0, None, None,
                     torch.cuda.current_stream().cuda_stream)
            _build.check(err, "flash_attn_fwd_bf16")
            return o

        g = torch.Generator(device="cuda").manual_seed(0)
        for B, S, H, KV, D in SHAPES:
            q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda")
                       .to(torch.bfloat16) for h in (H, KV, KV))
            want = fa.flash_attention_plain(q, k, v).float()
            line = f"forward B={B} S={S} H={H} KV={KV} D={D}:"
            for name, (fn, dims) in libs.items():
                if D not in dims:
                    continue
                got = run(fn, q, k, v)
                torch.cuda.synchronize()
                e = float((got.float() - want).abs().max())
                ms = time_ms(torch, lambda: run(fn, q, k, v))
                line += f" {name} {ms:.4f} ms (err {e:.2e});"
            qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qT, kT, vT, is_causal=True, enable_gqa=KV != H))
            print(f"{line} SDPA {sdpa:.4f} ms", flush=True)
    for B, S, H, KV, D in BWD_SHAPES:
        q, k, v, do = (torch.randn((B, S, h, D), generator=g, device="cuda")
                       .to(torch.bfloat16) for h in (H, KV, KV, H))
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
        ms = time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, do, lse))
        print(f"backward B={B} S={S} H={H} KV={KV} D={D}: {ms:.4f} ms",
              flush=True)


if __name__ == "__main__":
    main()
