#!/usr/bin/env python3
"""Design variants of K1 and K1b timed against the kernels as shipped, on
one NVIDIA GPU: the measurements behind the design choices of the register
K1 and K1b designs, and a split of each kernel's time.

    python3 chip_variants.py

Each variant is a shipped source (``muygpys_torch/gpu/csrc``) with one part
replaced by text substitution (each asserted to apply), built by nvcc with
the shipped flags under ``build/muygpys_torch/variants/`` and called through
the same C entry point on the same inputs as the shipped library.  The
design variants must give the shipped results bit for bit; the diagnostic
ones compute something else and are timed only.

- K1 ``whole row``: each lane evaluates its whole row of K instead of the
  lower triangle spread over the lanes and mirrored;
- K1 ``2 blocks``: the f32 one-target instantiation compiled for 2 resident
  blocks an SM (a 128-register cap) instead of 4 (64 registers);
- K1 ``no elimination`` (diagnostic): the kernel values alone: the
  elimination's share;
- K1 ``loads only`` (diagnostic): the block's loads and the outputs, no
  kernel values and no elimination: the floor of a launch;
- K1b ``other segments``: 64-byte segments of the batch-last inputs (16
  f32 or 8 f64 queries a block) instead of 32 (8 or 4);
- K1b ``register loads``: each input element loaded through a register,
  turned into its kernel value and stored to shared memory, instead of
  copied by cp.async and evaluated in place;
- K1b ``no elimination`` (diagnostic, the K1 library of that name): loads
  and kernel values: the elimination's share;
- K1b ``loads only`` (diagnostic): the loads and the outputs, no kernel
  values and no elimination.

Shapes: K1 at chip_smoke.py's serving headline, n = 30, d = 2, r = 1, B =
8192 (f32 and f64, Matern 3/2 and nu = 1.2), and K1b at the same shape from
the distances of such neighbourhoods.  Each comparison is timed by
chip_smoke.device_ms in the order shipped, variant, variant, shipped.
Prints the card's name and power limit and one line per comparison.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

def replaced(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, f"variant anchor not found once: {old[:60]!r}"
    return text.replace(old, new)


EMIT_ONLY = """  const bool live = lane < n;
  T x[XP];
#pragma unroll
  for (int k = 0; k < XP; ++k) x[k] = sm[oY + lane % n];
  const T zz = warp_sum(x[0] * x[0]);
  if (lane == 0) var[b] = T(1) - zz;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < r) {
      const T s = warp_sum(x[0] * x[1 + k]);
      if (lane == 0) mean[(size_t)k * B + b] = s;
    }
"""


K1B_REGISTER_LOADS = """  if (code == GEN) matern_nu::stage(co, gen, matern_nu::LEN_VAL, nt);
  __syncthreads();
  const T ls = params[0], noise = params[1];
  const T inv = metric_power == 1 ? T(1) / ls : T(1) / (ls * ls);
  for (int e = threadIdx.x; e < n * n * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;
    const int i = row / n, c = row % n;
    T v = T(0);
    if (b < B) {
      v = kernel_value(pw[(size_t)row * B + b] * inv, code, co, nt);
      if (i == c) v += noise;
    }
    base[w * per + i * kLdK + c] = v;
  }
  for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
    const int w = e % P, i = e / P, b = b0 + w;
    base[w * per + oC + i] = b < B ? kernel_value(cw[(size_t)i * B + b] * inv, code, co, nt) : T(0);
  }
  for (int e = threadIdx.x; e < n * r * P; e += blockDim.x) {
    const int w = e % P, row = e / P, b = b0 + w;
    base[w * per + oY + row] = b < B ? y[(size_t)row * B + b] : T(0);
  }
  __syncthreads();

"""


def k1_variants(src: str) -> dict:
    """The K1 and K1b variants' sources, by name."""
    tri_start = src.index("  {\n    int i = 0, j = lane;\n    while (j > i) j -= ++i;")
    tri_end = src.index("  const bool live = lane < n;\n  T x[XP];")
    whole_row = (src[:tri_start]
                 + "  if (lane < n) {\n    for (int c = 0; c < n; ++c) {\n"
                   "      T v = value(xs + lane * d, xs + c * d);\n"
                   "      if (c == lane) v += nugget(lane);\n"
                   "      Ks[c * kLdK + lane] = v;\n    }\n  }\n"
                 + src[tri_end:])
    # the register elimination both register designs share
    el_start = src.index("  // right-looking elimination of [K | kc | y], one rsqrt per pivot")
    el_end = src.index("  // lanes past n hold zeros")
    no_elim = (src[:el_start]
               + "#pragma unroll\n  for (int c = 0; c < kRows; ++c) x[0] += A[c];\n"
               + src[el_end:])
    call = "  regs_solve_and_emit<T, R>(A, x, rows, mean, var, n, r, b, B, lane);\n"
    call_end = src.index(call) + len(call)
    loads_only = src[:tri_start] + EMIT_ONLY + src[call_end:]
    two_blocks = replaced(src, "sizeof(T) == 4 ? (R == 1 ? 4 : 2) : 1;",
                          "sizeof(T) == 4 ? 2 : 1;")
    other_segments = replaced(src, "constexpr int kDistsSegmentBytes = 32;",
                              "constexpr int kDistsSegmentBytes = 64;")
    k1b_loads = replaced(no_elim, "      T v = kernel_value(*e * inv, code, co, nt);",
                         "      T v = *e * inv;")
    k1b_loads = replaced(
        k1b_loads, "q[oC + i] = kernel_value(q[oC + i] * inv, code, co, nt);",
        "q[oC + i] = q[oC + i] * inv;")
    copy_start = src.index("  // the copies of this thread's query")
    copy_end = src.index("  if (b0 + warp >= B) return;")
    register_loads = src[:copy_start] + K1B_REGISTER_LOADS + src[copy_end:]
    return {"whole row": whole_row, "2 blocks": two_blocks,
            "no elimination": no_elim, "loads only": loads_only,
            "other segments": other_segments, "K1b loads only": k1b_loads,
            "register loads": register_loads}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from muygpys_torch.gpu import _build
    from muygpys_torch.gpu import fused_predict as F
    from muygpys_torch.gpu import matern_nu as _nu

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    # build the shipped libraries and every variant, all nvcc started together
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, text in k1_variants(
            (_build.CSRC / "fused_predict.cu").read_text()).items():
        sources[("fused_predict", name)] = text
    procs = {}
    for (base, name), text in sources.items():
        stem = f"{base}_{name.replace(' ', '_')}"
        cu = out / f"{stem}.cu"
        cu.write_text(text)
        procs[(base, name)] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{stem}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), stem)
    _build.build()
    libs = {}
    for key, (proc, stem) in procs.items():
        log = proc.communicate()[0].decode()
        assert proc.returncode == 0, f"nvcc failed on the {key} variant:\n{log}"
        libs[key] = ctypes.CDLL(str(out / f"lib{stem}.so"))

    def compare(label, shipped, variants, exact):
        ref = shipped()
        for name, fn in variants.items():
            got = fn()
            torch.cuda.synchronize()
            if name in exact:
                assert all(torch.equal(a, b) for a, b in zip(ref, got)), (
                    f"{label}: the {name} variant differs")
            times = [cs.device_ms(torch, shipped), cs.device_ms(torch, fn),
                     cs.device_ms(torch, fn), cs.device_ms(torch, shipped)]
            print(f"{label}: shipped {times[0]:.4f} {times[3]:.4f} ms, {name} "
                  f"{times[1]:.4f} {times[2]:.4f} ms (device)", flush=True)

    # K1 at the serving headline
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.float64):
        for nu in (1.5, "gen"):
            n, d, r, B = cs.NN, cs.D, 1, cs.QUERIES
            f64 = dict(device="cuda", generator=g, dtype=torch.float64)
            nf = (torch.rand((n, d, B), **f64) * 0.05).to(dtype)
            q = (torch.rand((d, B), **f64) * 0.05).to(dtype)
            y = torch.randn((n, r, B), **f64).to(dtype)
            params = torch.tensor([cs.LS] * d + [cs.NOISE], dtype=dtype,
                                  device="cuda")
            gen = (cs.host_coeffs(torch, cs.NU_GEN, dtype)[:_nu._LEN_VAL]
                   .contiguous() if nu == "gen" else None)
            code = _nu.check_smoothness("K1", nu, gen, 1, _nu._LEN_VAL)

            def launcher(lib, nf=nf, q=q, y=y, params=params, gen=gen,
                         code=code, dtype=dtype):
                fn = getattr(lib, "fused_predict_coords_f32"
                             if dtype == torch.float32
                             else "fused_predict_coords_f64")
                fn.argtypes = F._COORDS_ARGTYPES

                def run():
                    mean = torch.empty((r, B), dtype=dtype, device="cuda")
                    var = torch.empty((B,), dtype=dtype, device="cuda")
                    rc = fn(*(_build.ptr(t) for t in (nf, q, y, params, None,
                                                      gen, mean, var)),
                            n, d, r, B, code, 1, F.serve_tail_terms(dtype), 1,
                            _build.stream(nf.device))
                    assert rc == 0, f"variant launch failed: {rc}"
                    return mean, var

                return run

            compare(
                f"K1 {str(dtype)[6:]} nu={nu}",
                lambda nf=nf, q=q, y=y, params=params, gen=gen, code=code,
                nu=nu: F._launch(nf, q, y, params, None, gen, code, 1, nu,
                                 design="registers"),
                {m: launcher(libs[("fused_predict", m)])
                 for m in ("whole row", "2 blocks", "no elimination",
                           "loads only")},
                exact={"whole row", "2 blocks"},
            )

    # K1b at the distance workflow's headline: the same neighbourhoods'
    # distances
    for dtype in (torch.float32, torch.float64):
        for nu in (1.5, "gen"):
            n, r, B = cs.NN, 1, cs.QUERIES
            f64 = dict(device="cuda", generator=g, dtype=torch.float64)
            pts = torch.rand((n, cs.D, B), **f64) * 0.05
            qq = torch.rand((cs.D, B), **f64) * 0.05
            pw = (pts[:, None] - pts[None]).pow(2).sum(2).sqrt().to(dtype).contiguous()
            cw = (pts - qq[None]).pow(2).sum(1).sqrt().to(dtype).contiguous()
            y = torch.randn((n, r, B), **f64).to(dtype)
            params = torch.tensor([cs.LS, cs.NOISE], dtype=dtype, device="cuda")
            gen = (cs.host_coeffs(torch, cs.NU_GEN, dtype)[:_nu._LEN_VAL]
                   .contiguous() if nu == "gen" else None)
            code = _nu.check_smoothness("K1b", nu, gen, 1, _nu._LEN_VAL)

            def launcher(lib, pw=pw, cw=cw, y=y, params=params, gen=gen,
                         code=code, dtype=dtype):
                fn = getattr(lib, "fused_predict_f32" if dtype == torch.float32
                             else "fused_predict_f64")
                fn.argtypes = F._DISTS_ARGTYPES

                def run():
                    mean = torch.empty((r, B), dtype=dtype, device="cuda")
                    var = torch.empty((B,), dtype=dtype, device="cuda")
                    rc = fn(*(_build.ptr(t) for t in (pw, cw, y, params, gen,
                                                      mean, var)),
                            n, r, B, code, 1, F.serve_tail_terms(dtype), 1,
                            _build.stream(pw.device))
                    assert rc == 0, f"variant launch failed: {rc}"
                    return mean, var

                return run

            compare(
                f"K1b {str(dtype)[6:]} nu={nu}",
                lambda pw=pw, cw=cw, y=y, params=params, gen=gen, code=code,
                nu=nu: F._launch_dists(pw, cw, y, params, gen, code, 1, nu,
                                       design="registers"),
                {m: launcher(libs[("fused_predict", m)])
                 for m in ("other segments", "register loads",
                           "no elimination", "K1b loads only")},
                exact={"other segments", "register loads"},
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
