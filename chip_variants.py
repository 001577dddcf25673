#!/usr/bin/env python3
"""Design variants of K3, K1 and K1b timed against the kernels as shipped, on
one NVIDIA GPU: the measurements behind the design choices of the fused K3
and the register K1 and K1b designs, and a split of each kernel's time.

    python3 chip_variants.py

Each variant is a shipped source (``muygpys_torch/gpu/csrc``) with one part
replaced by text substitution (each asserted to apply), built by nvcc with
the shipped flags under ``build/muygpys_torch/variants/`` and called through
the same C entry point on the same inputs as the shipped library.  The two
design variants must give the shipped results bit for bit; the diagnostic
ones compute something else and are timed only.

- K3 ``staged``: each live train tile staged in shared memory by
  double-buffered ``cp.async`` (one block-wide load serving the block's
  threads) instead of each thread reading its columns from L2;
- K3 ``walk only`` (diagnostic): the walk, its keys stored to shared memory,
  no selection: the selection's share of the kernel;
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

Shapes: chip_smoke.py's fused headline (50,000 uniform Morton-sorted 2-D
points, 8192 queries, 38 candidates at 512 bins; its subsample, pruned and
1024-bin searches), K1 at n = 30, d = 2, r = 1, B = 8192 (f32 and f64,
Matern 3/2 and nu = 1.2), and K1b at the same shape from the distances of
such neighbourhoods.  Each comparison is timed by chip_smoke.device_ms
in the order shipped, variant, variant, shipped.  Prints the card's name and
power limit and one line per comparison.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

STAGED_WALK = """  float* stage = reinterpret_cast<float*>(smem_raw);  // [2][FEAT + 1][train_tile]
  const int tile_elems = (FEAT + 1) * train_tile;
  auto next_live = [&](int j) {
    for (++j; j < nt; ++j)
      if (lb == nullptr || !(lb[(size_t)qtile * nt + j] > ub[qtile])) break;
    return j;
  };
  auto load = [&](int j, float* buf) {
    const int vecs = train_tile / 4;
    for (int e = tid; e < (FEAT + 1) * vecs; e += kThreads) {
      const int f = e / vecs, v = 4 * (e % vecs);
      const size_t col = (size_t)j * train_tile + v;
      const float* src = f < FEAT ? tT + (size_t)f * t_count + col : tsq + col;
      __pipeline_memcpy_async(buf + f * train_tile + v, src, 16);
    }
  };
  int j = next_live(-1), cur = 0;
  if (j < nt) load(j, stage);
  __pipeline_commit();
  while (j < nt) {
    const int jn = next_live(j);
    if (jn < nt) load(jn, stage + (cur ^ 1) * tile_elems);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* ts = stage + cur * tile_elems;
    for (int g = 0; g < cpt; ++g) {
      const int chunk = j * cpt + g;
#pragma unroll
      for (int b = 0; b < BPT; ++b) {
        const int col = g * BINS + b * kThreads + tid;
        float tf[FEAT];
#pragma unroll
        for (int f = 0; f < FEAT; ++f) tf[f] = ts[f * train_tile + col];
        const float tn = ts[FEAT * train_tile + col];
"""

STAGED_TAIL = """    __syncthreads();
    j = jn;
    cur ^= 1;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // keys of query t"""


def replaced(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, f"variant anchor not found once: {old[:60]!r}"
    return text.replace(old, new)


def knn_variants(src: str) -> dict:
    """The K3 variants' sources, by name."""
    walk_start = src.index("  for (int j = 0; j < nt; ++j) {\n    if (lb != nullptr",
                           src.index("knn_select_kernel("))
    body_start = src.index("#pragma unroll\n        for (int t = 0; t < kTQ; ++t) {\n"
                           "          float dot", walk_start)
    staged = src[:walk_start] + STAGED_WALK + src[body_start:]
    staged = replaced(staged, "    }\n  }\n\n  // keys of query t", "    }\n" + STAGED_TAIL)
    staged = replaced(staged, "#include <cuda_runtime.h>\n",
                      "#include <cuda_pipeline.h>\n#include <cuda_runtime.h>\n")
    staged = replaced(
        staged, "  const size_t bytes = select_smem_bytes(BPT * kThreads);",
        "  const size_t staged = sizeof(float) * 2 * (FEAT + 1) * (size_t)train_tile;\n"
        "  const size_t select = select_smem_bytes(BPT * kThreads);\n"
        "  const size_t bytes = staged > select ? staged : select;")
    sel_start = src.index("  const int warp = tid / 32, lane = tid % 32;\n  const unsigned full")
    sel_end = src.index("    out_d2[row + rank] = d2;\n  }\n", sel_start)
    sel_end += len("    out_d2[row + rank] = d2;\n  }\n")
    walk_only = (src[:sel_start]
                 + "  if (tid < kTQ) out_d2[(size_t)(q0 + tid) * k] = "
                   "__int_as_float(keys[tid * 2 * BINS + (k & (BINS - 1))]);\n"
                 + src[sel_end:])
    return {"staged": staged, "walk only": walk_only}


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
    from muygpys_torch.gpu import knn as K
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
    for name, text in knn_variants((_build.CSRC / "knn.cu").read_text()).items():
        sources[("knn", name)] = text
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

    # K3 at the fused path's shapes
    g = torch.Generator(device="cuda").manual_seed(1)
    train = torch.rand((cs.TRAIN, cs.D), device="cuda", generator=g)
    train = train[K.spatial_sort(train)].contiguous()
    queries = torch.rand((cs.QUERIES, cs.D), device="cuda", generator=g)
    index = K.build_index(train, pruned=True)
    pruned = K.prepare_pruned(None, queries, cs.NN + 8, train_index=index)
    cases = (
        ("unpruned", K.prepare(train, queries, cs.NN + 8), cs.NN + 8),
        ("subsample", K.prepare(None, pruned.q, cs.NN + 8,
                                train_index=index.sub), cs.NN + 8),
        ("pruned", pruned, cs.NN + 8),
        ("pruned 1024 bins", K.prepare_pruned(train, queries, cs.NN + 32,
                                              bins=1024), cs.NN + 32),
    )
    for label, prep, k in cases:
        def launcher(lib, prep=prep, k=k):
            fn = lib.knn_select
            fn.argtypes = K._SELECT_ARGTYPES

            def run():
                q_count = prep.q.shape[0]
                idx = torch.zeros((q_count, k), dtype=torch.int64, device="cuda")
                d2 = torch.zeros((q_count, k), dtype=torch.float32, device="cuda")
                rc = fn(*(_build.ptr(t) for t in prep[:6]), _build.ptr(idx),
                        _build.ptr(d2), q_count, prep.q.shape[1],
                        prep.tT.shape[1], prep.bins, prep.train_tile,
                        prep.query_tile, prep.chunk_mask, k, prep.train_count,
                        _build.stream(prep.q.device))
                assert rc == 0, f"variant launch failed: {rc}"
                return idx, d2

            return run

        compare(f"K3 {label}", lambda prep=prep, k=k: K.knn_select(prep, k),
                {n: launcher(libs[("knn", n)]) for n in ("staged", "walk only")},
                exact={"staged"})

    # K1 at the serving headline
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
