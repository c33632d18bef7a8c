#!/usr/bin/env python3
"""Time variants of X2 (``csrc/block_score.cu``) against the kernel as it
stands, in one process on one CUDA card.

    python3 chip_x2_variants.py

Each variant is this checkout's source with named text substitutions,
built by its own ``nvcc`` (the port's flags) into ``build/x2_variants/``
and bound with ``ctypes`` in place of the port's launcher. The variants:

- ``tf8``: the tf table's first 8 freqs of each norm staged in shared
  memory (4 KB), the rest on ``__ldg``;
- ``tf16_min3``: its first 16 freqs (8 KB), three blocks a SM;
- ``min_blocks_3``: three blocks a SM (up to 85 registers, not 64);
- ``global_decode``: every block decoded from global memory, the
  staged words unused;
- ``load_first``: a lane's four sums read before any is written;
- diagnostics, whose results are wrong and not checked, bounding parts
  of the kernel: ``no_run_barrier`` (no barrier between runs),
  ``no_decode`` (no run added: prologue, staging and epilogue only),
  ``no_topk`` (no candidates written).

On the 1M-doc corpus of ``chip_smoke.py`` phase 5 (built, not read from
disk), or20 and the mixed boolean of phase 14: every checked variant's
score form (k 10) must equal the plain version bit for bit; then each
variant's score form and count form, kernel only (``queued_ms``: 20
calls behind a device sleep, the median of 3), in turns (the kernel,
then each variant, then back). ms, with the card's name and power limit.

It imports nothing of JAX or of the JAX package.
"""

import ctypes
import statistics
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "x2_variants"

_TF_LOOKUP = "      c[e] = __fmul_rn(w, __ldg(a.tf_lut + norm * a.F + freq));"
_SUMS = """#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d[e] < 0) continue;
    float4 v = t.acc[d[e]];
    if (kScore) v.x = __fadd_rn(v.x, c[e]);
    v.y = __fadd_rn(v.y, rq);
    v.z = __fadd_rn(v.z, sh);
    v.w = __fadd_rn(v.w, ng);
    t.acc[d[e]] = v;
  }"""


def _tf(cols, min_blocks=4):
    """Substitutions that stage the tf table's first ``cols`` freqs."""
    total = "  L.total = L.batch + align16((kRunsWin + 1) * 4);"
    return [
        (total, total[:-1] + f" + (score ? 128 * {cols} * 4 : 0);"),
        ("  const uint8_t* doc8;  // [n]: norm (7 bits) | live << 7",
         "  const uint8_t* doc8;  // [n]: norm (7 bits) | live << 7\n"
         "  const float* tf;"),
        ("  t.doc8 = s_doc8;",
         "  t.doc8 = s_doc8;\n"
         "  float* s_tf = (float*)(smem + L.batch +"
         " align16((kRunsWin + 1) * 4));\n"
         "  t.tf = s_tf;\n"
         f"  if (kScore) for (int i = tid; i < 128 * {cols}; i += kThreads)"
         f" s_tf[i] = i % {cols} < a.F ? __ldg(a.tf_lut + (i / {cols}) *"
         f" a.F + i % {cols}) : 0.f;"),
        (_TF_LOOKUP,
         f"      c[e] = __fmul_rn(w, freq < {cols} ? t.tf[norm * {cols} +"
         " freq] : __ldg(a.tf_lut + norm * a.F + freq));"),
        ("constexpr int kMinBlocks = 4;",
         f"constexpr int kMinBlocks = {min_blocks};"),
    ]


# name -> (results checked against the plain version, substitutions)
VARIANTS = {
    "tf8": (True, _tf(8)),
    "tf16_min3": (True, _tf(16, 3)),
    "min_blocks_3": (True, [("constexpr int kMinBlocks = 4;",
                             "constexpr int kMinBlocks = 3;")]),
    "global_decode": (True, [(
        "    if (soff >= 0 && wo >= ws && wo + nw <= we && nw <= a.ww) {",
        "    if (false) {")]),
    "load_first": (True, [(_SUMS, """  float4 v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d[e] >= 0) v[e] = t.acc[d[e]];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d[e] < 0) continue;
    if (kScore) v[e].x = __fadd_rn(v[e].x, c[e]);
    v[e].y = __fadd_rn(v[e].y, rq);
    v[e].z = __fadd_rn(v[e].z, sh);
    v[e].w = __fadd_rn(v[e].w, ng);
    t.acc[d[e]] = v[e];
  }""")]),
    "no_run_barrier": (False, [(
        "        add_run<kScore>(a, t, qb, i, s_run, w, h, warp, lane);\n"
        "        __syncthreads();",
        "        add_run<kScore>(a, t, qb, i, s_run, w, h, warp, lane);")]),
    "no_decode": (False, [(
        "        add_run<kScore>(a, t, qb, i, s_run, w, h, warp, lane);",
        "        (void)w; (void)h;")]),
    "no_topk": (False, [
        ("    if (a.kk <= kFastK && a.kk < t.n) {", "    if (a.kk < 0) {"),
        ("      topk_sort(a, t, s_final, s_keys, out, tid);",
         "      (void)s_keys;")]),
}


def build():
    """{variant: its launcher}, every variant's nvcc started at once; the
    ptxas lines of each are logged."""
    from diagon_tpu_torch.ops import _build

    src = (_build.CSRC / "block_score.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source has no {old[:60]!r}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = OUT / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in out.splitlines()
                if "registers" in ln or "spill stores" in ln]
        cs.log(f"  {name}: " + "; ".join(regs))
        fn = ctypes.CDLL(str(so)).diagon_block_score
        fn.argtypes = _build._SIGNATURES["diagon_block_score"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_x2_variants: torch.cuda.is_available() is "
                         "false")
    smi = cs.phase_device()
    from diagon_tpu_torch.bench.queries import frequent_terms
    from diagon_tpu_torch.ops import _build
    from diagon_tpu_torch.ops import block_score as bs
    from diagon_tpu_torch.search import engine

    fns = {"kernel": _build.library().diagon_block_score, **build()}
    port = _build._lib

    def use(name):
        _build._lib = SimpleNamespace(diagon_block_score=fns[name])

    _, s1, _, _ = cs.load_searcher(cs.SCALE_DOCS)
    ex = engine.SegmentExecutor(s1.device_segments[0], "body",
                                s1._ctx("body").tf_lut_host)
    queries = cs.block_queries(frequent_terms(s1), False)
    names = list(fns)
    try:
        for qn in ("or20", "mixed"):
            args = cs.x2_args(ex, [cs.block_plan(s1, queries[qn])])
            want = bs.block_score_reference(*args, k=cs.K,
                                            tile=cs.x2_tile(args))
            for name in names:
                use(name)
                got = bs.block_score(*args, k=cs.K)
                torch.cuda.synchronize()
                if (name == "kernel" or VARIANTS[name][0]) and not (
                        cs.bits_equal(got[0], want[0])
                        and torch.equal(got[1], want[1])
                        and torch.equal(got[2], want[2])):
                    raise AssertionError(f"{name} {qn}: != plain")
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                use(name)
                score = statistics.median(cs.queued_ms(
                    lambda: bs.block_score(*args, k=cs.K), 20)
                    for _ in range(3))
                count = statistics.median(cs.queued_ms(
                    lambda: bs.block_score(*args, scores=False), 20)
                    for _ in range(3))
                times[name].append((score, count))
            cs.log(f"X2 variants, 1M {qn}, tile {cs.x2_tile(args)}: score "
                   "/ count form kernel only ms, in turns there and back "
                   f"[{smi}]")
            for name in names:
                cs.log(f"  {name}: " + "; ".join(
                    f"{s:.4f} / {c:.4f}" for s, c in times[name]))
    finally:
        _build._lib = port


if __name__ == "__main__":
    main()
