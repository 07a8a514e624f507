#!/usr/bin/env python3
"""K13 (exact repeatability) and K10's head (pair selection) on one NVIDIA
card: where their time goes, two checkouts' kernels held bit for bit and
timed in turns, and the host pose data of the match stage in parts.

    python3 scripts/torch_match_probe.py [--parent DIR] [--order ABBA]
        [--variants paths,pairs,repeat,select,gather]

Runs chip_smoke.py's bench fit once in this checkout and records the
inputs of every K10 head call (engine/match.pair_head) and every K13 call
(engine/match.exact_repeat: the match stage's head pairs), then the
rescue case (chip_smoke.rescue_args) docked on the card, which records
K13's calls there, the rescue round's re-score (engine/docking.py's
exact_rescore) the last, and the bench dock on a mesh of 4 shards of the
card, which records the merge of the shards' heads (K10's merge, D1) and
shard 1's K12 and K13 calls (D2). All are saved under mad_tpu_torch/_build/
with stress inputs: K13 at chip_smoke.K13_STRESS (400 subunit and 5,000
map anchors), K10's head at (24, 16411) and (300, 700) cosines on a grid
of levels (as tests/test_torch_match_cuda.py) and on the bench's cosines
with max_pairs chip_smoke.K10_CUT_PAIRS, so that it keeps fewer keys than
its row heads hold.
The fit's descriptor sets are saved too, for the match stage
(engine/match.match_descriptors at the fit's min_exact): each checkout
times it whole (host clock, synchronized, median of 7) and its selection
span, from K12's return to K13's call (both synchronized; median of 7):
the host argsort and the pushes of the gathered rows before K21, K21
since; the two checkouts' tables are held equal bit for bit.
Prints each input's shape, and the host pose data of match_pairs
(engine/match.py) on the bench's pairs in parts: the keys' pull, their
decode (split_pair_keys), the two per-pair np.unique(..., axis=0) calls,
the rfinal gathers, the R_lo^T R_hi einsum and the coordinate copies
(median of 7, host clock), beside what match_pairs runs in their place:
np.unique of the distinct rows' coordinates (engine/match._cloud) and the
rotations summed in j's order (_relative_rotations).

Then, for every letter of ``--order`` (A the checkout ``--parent``, B this
one; this one alone, once, without ``--parent``), one process in that
checkout loads the inputs, runs its own kernels on them and times each
alone (chip_smoke.bare / kernel_ms: the wrapper's one launcher call
repeated on the same buffers) and its wrapper (chip_smoke.cuda_ms, mean of
ten); D2 is the wrappers of K12 and K13 called in turn, as chip_smoke's
repeat_shard row. The two checkouts' outputs are held equal bit for bit.
Each of ``--variants`` times, on the same recorded launcher calls (alone,
every call whose export the build has), builds of this checkout's
csrc/pairs.cu or csrc/repeat.cu with lines changed, all compiled at once,
in B's first process (A's without ``--parent``):
  * paths: K10's head and merge with each sort by rank replaced by the
    bitonic sort (kRankMax 0), without the radix select's rank finish
    (kFinish never taken: one more 8-bit pass instead), and with
    neither;
  * pairs: the row stage empty (its launch), its counting read alone,
    both reads alone, without its sort, the stage alone; the global stage
    empty, its bucket alone, its searches and gathers alone, without its
    sort, the stage alone (on the last call's bounds); the bucket's bounds
    alone, with its sample, and whole; buckets of 64 and 256 slots;
  * repeat: K13 with 1, 4 and 8 running minima a lane, and 4 and 16 warps
    a block;
  * select: K21's one launch (csrc/select_exact.cu) without the radix
    selects' rank finish, with %globaltimer read by the first CTA at its
    phases (the fit's call: load, select, compact into the first CTA,
    barrier, AND and OR of the heads, second select, compact, sort,
    barrier and the gathers), at 512 threads a CTA, and with a rank
    finish at 128 keys (not 64);
  * gather: K8 (csrc/gather_norm.cu) with __fdiv_rn in place of its
    quotients from the row's reciprocal, without their two corrections
    (wrong bits), without its float32 stores, at 8 warps a block, and
    with each lane storing its own words' float32 (two 16-byte stores 32
    bytes apart) in place of the words rearranged by shuffles.
K8 (engine/pipeline.gather_norm: the fit's map and subunit calls) and
K21 (engine/match.select_exact, the match stage's call in the bench fit,
also at n_use = P) is timed in a checkout that has it, and in a checkout
whose wrapper chooses between one launch and three (``one_launch``) also
with the three launches forced at the fit's call.
Prints the card's name and power limit first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in a checkout (cwd), its mad_tpu_torch; the helpers (bare,
# kernel_ms, ...) from this checkout's chip_smoke, loaded by path.
CHILD = r"""
import ctypes, importlib.util, inspect, json, re, subprocess, sys, time
import torch
from mad_tpu_torch.kernels import build, approx as k12, pairs as k10
from mad_tpu_torch.kernels import repeat as k13, gather_norm as k8
smoke, inputs, out_path, variants = (sys.argv[1], sys.argv[2], sys.argv[3],
                                     json.loads(sys.argv[4]))
CLOCK_PHASES = json.loads(sys.argv[5])
spec = importlib.util.spec_from_file_location("smoke_helpers", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
device, _smi = cs.device_phase()
cs.build_phase()
# the variants' builds, all at once
procs = []
for name, src, edits in variants:
    text = (build.CSRC / src).read_text()
    for old, new in edits:
        cs.check(len(re.findall(old, text, re.S)) == 1,
                 f"csrc/{src} has no single {old!r}")
        text = re.sub(old, new, text, flags=re.S)
    stem = "probe_" + "".join(c if c.isalnum() else "_" for c in name)
    cu, so = build.BUILD_DIR / f"{stem}.cu", build.BUILD_DIR / f"{stem}.so"
    cu.write_text(text)
    procs.append((name, so, subprocess.Popen(
        [build._nvcc()] + build.ARCH_FLAGS + build.NVCC_FLAGS
        + ["-I", str(build.CSRC), "-shared", "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
built = []
for name, so, proc in procs:
    log, _ = proc.communicate()
    cs.check(proc.returncode == 0, f"variant {name}: nvcc failed\n{log}")
    built.append((name, ctypes.CDLL(str(so))))
inp = torch.load(inputs, weights_only=False, map_location=device)
res, outs, bares = {}, {}, {}
kinds = [("K13", k13.exact_repeat), ("K10", k10.pair_head),
         ("K10 merge", k10.pair_merge), ("K8", k8.gather_norm)]
try:
    from mad_tpu_torch.kernels import select_exact as k21
    kinds.append(("K21", k21.select_exact))
except ImportError:          # a checkout from before K21
    pass
for kind, fn in kinds:
    for label, a in inp[kind]:
        key = f"{kind} {label}"
        got = fn(*a)
        outs[key] = [x.cpu() for x in (got if isinstance(got, tuple)
                                        else (got,))]
        r = cs.bare(lambda: fn(*a))
        bares[key] = r
        res[key + " alone"] = cs.kernel_ms(r)
        res[key + " wrapper"] = cs.cuda_ms(lambda: fn(*a), reps=10)
# K21's three launches at the one launch's shapes (a checkout whose
# wrapper chooses between the two)
if "K21" in dict(kinds) and hasattr(k21, "one_launch"):
    one, k21.one_launch = k21.one_launch, lambda P, n_use: False
    for label, a in inp["K21"]:
        if one(a[0].shape[0], a[4]):
            key = f"K21 {label}, three launches"
            r = cs.bare(lambda: k21.select_exact(*a))
            res[key + " alone"] = cs.kernel_ms(r)
            res[key + " wrapper"] = cs.cuda_ms(lambda: k21.select_exact(*a),
                                               reps=10)
    k21.one_launch = one
for label, (a12, a13) in inp["D2"]:
    if len(a12) == 9 and "vox" not in inspect.signature(
            k12.approx_repeat).parameters:     # a checkout without the map
        a12 = (a12[0],) + tuple(a12[3:])
    d2 = lambda: (k12.approx_repeat(*a12), k13.exact_repeat(*a13))
    outs[f"D2 {label}"] = [x.cpu() for x in d2()]
    res[f"D2 {label} wrapper"] = cs.cuda_ms(d2, reps=10)
# the match stage (match_descriptors, host clock), and its selection span:
# from K12's return to K13's call, each side synchronized
from mad_tpu_torch.engine import match as em
m, s, shape, origin, voxsp, mc, min_exact = inp["match"]
stage = lambda: em.match_descriptors(m, s, shape, origin, voxsp, mc,
                                     min_exact=min_exact, device=device)
table = stage()
outs["match table"] = [torch.as_tensor(a) for a in (
    table.repeat, table.hi_idx, table.lo_idx, table.rot)]
walls, spans, marks = [], [], {}
real12, real13 = em.approx_repeat, em.exact_repeat
def k12_spy(*a):
    out = real12(*a)
    torch.cuda.synchronize()
    marks["12"] = time.perf_counter()
    return out
def k13_spy(*a):
    torch.cuda.synchronize()
    marks.setdefault("13", time.perf_counter())
    return real13(*a)
for spied in (False, True):
    em.approx_repeat, em.exact_repeat = ((k12_spy, k13_spy) if spied
                                         else (real12, real13))
    for _ in range(7):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        if spied:
            spans.append((marks["13"] - marks["12"]) * 1e3)
        else:
            walls.append((time.perf_counter() - t0) * 1e3)
em.approx_repeat, em.exact_repeat = real12, real13
res["match stage, host clock"] = sorted(walls)[3]
res["match stage, K12 to K13"] = sorted(spans)[3]
for name, lib in built:
    for key, r in bares.items():
        export = r.call[0].__name__
        if hasattr(lib, export):
            fn = getattr(lib, export)
            fn.argtypes = build.SIGNATURES[export]
            fn.restype = ctypes.c_int
            res[f"{key} alone, {name}"] = cs.kernel_ms(
                lambda: build.launch(fn, *r.call[1:]))
            if name == "clock" and key == "K21 call 0":
                # the first CTA's phases (ns, %globaltimer) in top
                torch.cuda.synchronize()
                top = next(t for t in r.kept if isinstance(t, torch.Tensor)
                           and t.data_ptr() == r.call[9])
                for i, d in enumerate(top[:len(CLOCK_PHASES)].tolist()):
                    res[f"K21 clock {i} ({CLOCK_PHASES[i]}), us"] = d / 1e3
torch.save(outs, out_path)
print("RESULT " + json.dumps(res))
"""

# Builds with lines changed: (name, source, [(regex, replacement), ...]).
_NO_RANK = (r"constexpr int kRankMax = \d+;", "constexpr int kRankMax = 0;")
_NO_FINISH = (r"if \(cnt <= kFinish\) \{", "if (cnt < 0) {")
PATHS = (
    ("bitonic sorts only (kRankMax 0)", "pairs.cu", [_NO_RANK]),
    ("no rank finish", "pairs.cu", [_NO_FINISH]),
    ("neither", "pairs.cu", [_NO_RANK, _NO_FINISH]),
)

# The row and global stages' parts, and K13's shape:
_ROWS = [(r"row_heads<<<dh, kRowThreads, smem, stream>>>\(sim, dl, k, kp, "
          r"thr, row0,\s*cap, heads, counts, plan\);", ""),
         (r"if \(err == cudaSuccess\)\n    err = cudaMemsetAsync\(plan, 0, "
          r"kPlan \* sizeof\(u64\), stream\);", "")]
_GLOBAL = (r"select_runs<<<buckets\(N\), kSelThreads, 0, stream>>>\(\s*"
           r"Runs\{heads, N, kp, counts\}, dh, L, plan, out\);", "")
_ROW_END = ("  if (row >= 0) {{ if (threadIdx.x == 0) counts[row] = {}; "
            "return; }}\n")
PAIRS = (
    ("row stage, empty", "pairs.cu",
     [_GLOBAL, (r"  // 1\. the survivors: counted",
                "  if (row >= 0) return;\n  // 1. the survivors: counted")]),
    ("row stage, its count alone", "pairs.cu",
     [_GLOBAL, (r"  all_and = warp_reduce\(all_and, 0\);\n",
                _ROW_END.format("mine + static_cast<int>(all_and & 1)")
                + "  all_and = warp_reduce(all_and, 0);\n")]),
    ("row stage, its two reads alone", "pairs.cu",
     [_GLOBAL, (r"  // f\(key\) on every survivor, from shared memory or "
                r"the row\n", _ROW_END.format("n"))]),
    ("row stage without its sort", "pairs.cu",
     [_GLOBAL, (r"    rank_scatter\(sel, s, head, s\);",
                "    for (int i = threadIdx.x; i < s; i += blockDim.x) "
                "head[i] = sel[i];")]),
    ("row stage alone", "pairs.cu", [_GLOBAL]),
    ("global stage, empty", "pairs.cu",
     _ROWS + [(r"  // ~0 after the real keys\n", "  if (L >= 0) return;\n")]),
    ("global stage, its bucket's bounds alone", "pairs.cu",
     _ROWS + [(r"  const u64 span = hi - lo;\n",
               "  if (L >= 0) { *cur = *end = lo; return; }"
               "\n  const u64 span = hi - lo;\n")]),
    ("global stage, its bucket's sample alone", "pairs.cu",
     _ROWS + [(r"  // inclusive scan of the bins in place, "
               r"per consecutive bins a thread\n",
               "  if (L >= 0) { *cur = *end = lo; return; }\n")]),
    ("global stage, its bucket alone", "pairs.cu",
     _ROWS + [(r"            &cur, &end\);\n",
               "            &cur, &end);\n  if (L >= 0) return;\n")]),
    ("global stage, its searches and gathers alone", "pairs.cu",
     _ROWS + [(r"      if \(off >= L\) return;\n",
               "      if (off >= 0) return;\n")]),
    ("global stage without its sort", "pairs.cu",
     _ROWS + [(r"      rank_scatter\(buf, static_cast<int>\(c\), out \+ "
               r"off, L - off\);",
               "      for (int i = threadIdx.x; i < c && off + i < L; "
               "i += blockDim.x) out[off + i] = buf[i];")]),
    ("global stage alone", "pairs.cu", _ROWS),
) + tuple(
    (f"buckets of {n} slots", "pairs.cu",
     [(r"constexpr int kBucketKeys = \d+;",
       f"constexpr int kBucketKeys = {n};")]) for n in (64, 256))
_CLOCK_PHASES = ("load", "select", "compact into the first CTA",
                 "cluster barrier", "AND and OR of the heads",
                 "second select", "compact", "sort", "barrier and gather")
_CLOCK = [
    (r"(namespace \{\n\ntypedef unsigned long long u64;\n)",
     "\\1\n__device__ __forceinline__ u64 mad_clock() {\n  u64 t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    (r"(  if \(tid == 0\) s_n = 0;\n  for \(int i = tid; i < kBins; )",
     "  u64 mc[9];\n  mc[0] = mad_clock();\n\\1"),
    (r"(  u64 mask = 0, prefix = kNone;            // every key\n)",
     "  mc[1] = mad_clock();\n\\1"),
    (r"(  compact\(keys, n, mask, prefix, cluster.map_shared_rank\(heads, "
     r"0\) \+ at,\n          &s_n\);\n)",
     "  mc[2] = mad_clock();\n\\1  mc[3] = mad_clock();\n"),
    (r"(  if \(rank == 0\) \{\n    a = kNone;\n)",
     "  mc[4] = mad_clock();\n\\1"),
    (r"(    mask = 0;\n    prefix = kNone;\n    if \(m > n_use\))",
     "    mc[5] = mad_clock();\n\\1"),
    (r"(    compact\(heads, m, mask, prefix, head, &s_n\);\n)",
     "    mc[6] = mad_clock();\n\\1    mc[7] = mad_clock();\n"),
    (r"(    else sort_rows<4>\(head, n_use, ib, keys, rows\);\n)",
     "\\1    mc[8] = mad_clock();\n"),
    (r"(  cluster_wait\(\);\n)\}",
     "\\1  if (rank == 0 && tid == 0) {\n"
     "    const u64 e = mad_clock();\n"
     "    for (int i = 0; i < 8; ++i) top[i] = mc[i + 1] - mc[i];\n"
     "    top[8] = e - mc[8];\n  }\n}"),
]
SELECT = (
    ("no rank finish", "select_exact.cu",
     [(r"if \(cnt <= kFinish\) \{", "if (cnt < 0) {")]),
    ("clock", "select_exact.cu", _CLOCK),
    ("512 threads a CTA", "select_exact.cu",
     [(r"constexpr int kThreads = \d+;", "constexpr int kThreads = 512;")]),
    ("a rank finish at 128 keys", "select_exact.cu",
     [(r"constexpr int kFinish = \d+;", "constexpr int kFinish = 128;")]),
)
REPEAT = tuple(
    (f"{n} minima a lane", "repeat.cu",
     [(r"constexpr int kMinima = \d+;", f"constexpr int kMinima = {n};")])
    for n in (1, 4, 8)) + tuple(
    (f"{n} warps a block", "repeat.cu",
     [(r"constexpr int kWarps = \d+;", f"constexpr int kWarps = {n};")])
    for n in (4, 16))


_QUOTIENT = (r"  float q = __fmul_rn\(a, inv\);\n.*?"
             r"return __fmaf_rn\(__fmaf_rn\(-q, len, a\), inv, q\);")
_OWN_WORDS = """#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = lane + 32 * k;
    if (c >= C) break;
    u[2 * c] = make_float4(unit_of(lo16(v[k].x), len, inv),
                           unit_of(hi16(v[k].x), len, inv),
                           unit_of(lo16(v[k].y), len, inv),
                           unit_of(hi16(v[k].y), len, inv));
    u[2 * c + 1] = make_float4(unit_of(lo16(v[k].z), len, inv),
                               unit_of(hi16(v[k].z), len, inv),
                               unit_of(lo16(v[k].w), len, inv),
                               unit_of(hi16(v[k].w), len, inv));
  }
}
"""
GATHER = (
    ("K8 with __fdiv_rn a bin", "gather_norm.cu",
     [(_QUOTIENT, "return __fdiv_rn(a, len);")]),
    ("K8 without its quotients' corrections", "gather_norm.cu",
     [(_QUOTIENT, "return a * inv;")]),
    ("K8 without its float32 stores", "gather_norm.cu",
     [(r"      if \(j < 2 \* C\)\n        u\[j\] = make_float4\(.*?inv\)\);\n",
       "")]),
    ("K8 at 8 warps a block", "gather_norm.cu",
     [(r"constexpr int kWarps = \d+;", "constexpr int kWarps = 8;")]),
    ("K8 with each lane's own float32 words stored", "gather_norm.cu",
     [(r"  // float4 j of the row \(bins.*?\n  \}\n\}\n", _OWN_WORDS)]),
)


def host_split(m, s, cfg, reps=7):
    """match_pairs' host work on the bench's pairs, in parts: median
    milliseconds (host clock) of each."""
    import numpy as np
    from mad_tpu_torch.engine import match as em
    from mad_tpu_torch.kernels.pairs import split_pair_keys

    def ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    keys = em.pair_head(s.desc_norm @ m.desc_norm.T, cfg.row_cap,
                        cfg.max_pairs, float(cfg.cc_threshold))
    dl = m.desc_norm.shape[0]
    host = keys.cpu().numpy()
    _c, rows, cols = split_pair_keys(host, dl)
    hi_xyz, lo_xyz = s.subv_coords[rows], m.subv_coords[cols]
    same = (np.array_equal(np.unique(s.subv_coords[np.unique(rows)],
                                     axis=0), np.unique(hi_xyz, axis=0))
            and np.array_equal(np.unique(m.subv_coords[np.unique(cols)],
                                         axis=0), np.unique(lo_xyz, axis=0)))
    r_hi, r_lo = s.rfinal[rows], m.rfinal[cols]
    parts = {
        "pull (keys.cpu)": ms(lambda: keys.cpu().numpy()),
        "split_pair_keys": ms(lambda: split_pair_keys(host, dl)),
        "np.unique subunit anchors": ms(lambda: np.unique(hi_xyz, axis=0)),
        "np.unique map anchors": ms(lambda: np.unique(lo_xyz, axis=0)),
        "rfinal gathers": ms(lambda: (s.rfinal[rows], m.rfinal[cols])),
        "einsum R_lo^T R_hi": ms(lambda: np.einsum("pji,pjk->pik", r_lo,
                                                   r_hi)),
        "coordinate copies": ms(lambda: (s.subv_coords[rows],
                                         m.subv_coords[cols])),
        "np.unique of the distinct rows (both)": ms(lambda: (
            em._cloud(s.subv_coords, rows), em._cloud(m.subv_coords, cols))),
        "R_lo^T R_hi in j's order": ms(lambda: em._relative_rotations(
            r_lo, r_hi)),
        "match_pairs whole": ms(lambda: em.match_pairs(m, s, cfg)),
    }
    print(f"host pose data, {len(rows)} pairs ({len(np.unique(rows))} "
          f"subunit, {len(np.unique(cols))} map rows), median of {reps}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; the distinct rows' clouds equal np.unique's: {same}",
          flush=True)


def level_cosines(device):
    """K10's head on cosines of a grid of levels, many equal (the shapes of
    tests/test_torch_match_cuda.py): (label, pair_head arguments)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(15)
    out = []
    for dh, dl, row_cap, max_pairs, levels in ((24, 16411, 128, 2000, 97),
                                               (300, 700, 128, 65536,
                                                1 << 20)):
        sim = (rng.integers(0, levels, (dh, dl)) / levels * 1.5 - 0.5)
        out.append((f"stress {dh} x {dl}", (torch.as_tensor(
            sim.astype(np.float32), device=device), row_cap, max_pairs,
            0.6)))
    return out


def record(cs, path):
    """Run the bench fit with K10's head and K13 recorded, then the rescue
    case and the bench dock on 4 shards (K13; K10's merge, K12 and K13 of
    shard 1); save their inputs (and the stress inputs) to ``path``; print
    their shapes and the host pose data's parts."""
    import torch
    from mad_tpu_torch.engine import docking, match as em, pipeline
    from mad_tpu_torch.parallel.mesh import make_mesh
    from mad_tpu_torch.testing import recording
    device, _smi = cs.device_phase()
    cs.build_phase()
    cfg = cs.bench_config()
    with recording(em, "pair_head") as heads, \
            recording(em, "exact_repeat") as reps, \
            recording(em, "select_exact") as sels, \
            recording(pipeline, "gather_norm") as gathers:
        fit = cs.run_fit(device, None, cfg)
    k8 = [(label, a) for label, a in zip(("map", "subunit"), gathers)]
    for label, (tables, keeps) in k8:
        cs.say(f"K8 {label}: {sum(len(k) for k in keeps)} rows of "
               f"{tables[0].shape[1]} from {[len(t) for t in tables]}")
    k21 = []
    for r, a in enumerate(sels):
        k21 += [(f"call {r}", a), (f"call {r}, n_use = P",
                                   a[:4] + (a[0].shape[0],))]
        cs.say(f"K21 call {r}: {a[0].shape[0]} scores, n_use {a[4]}")
    k10 = []
    for r, a in enumerate(heads):
        k10.append((f"call {r}", a))
        n = (a[0] > a[3]).sum(dim=1).float()
        cs.say(f"K10 head call {r}: {tuple(a[0].shape)} cosines, row_cap "
               f"{a[1]}, max_pairs {a[2]}, threshold {a[3]:g}; survivors a "
               f"row min {int(n.min())}, median {int(n.median())}, max "
               f"{int(n.max())}")
    a = heads[0]
    k10.append((f"call 0, max_pairs {cs.K10_CUT_PAIRS}",
                (a[0], a[1], cs.K10_CUT_PAIRS) + a[3:]))
    k13 = []
    for r, a in enumerate(reps):
        k13.append((f"call {r}", a))
        cs.say(f"K13 call {r}: {a[2].shape[0]} pairs x "
               f"{a[0].shape[0]} x {a[1].shape[0]} anchors")
    k13.append(("stress", cs.k13_stress_args(device)))
    k10 += level_cosines(device)
    # the rescue case on the card: its last K13 call is the re-score
    args, _copies = cs.rescue_args(device, cfg)
    with recording(em, "exact_repeat") as reps, \
            recording(docking, "exact_rescore") as rescue:
        docking.dock_structure(*args, verbose=False,
                               n_copies=cs.RESCUE["n_copies"],
                               device=device)
    cs.check(len(rescue) == 1 and len(reps) >= 2
             and reps[-1][2].shape[0] == len(rescue[0][1]),
             f"rescue case: {len(rescue)} re-scores, {len(reps)} K13 calls")
    for r, a in enumerate(reps):
        label = ("rescue re-score" if r == len(reps) - 1
                 else f"rescue case call {r}")
        k13.append((label, a))
        cs.say(f"K13 {label}: {a[2].shape[0]} pairs x {a[0].shape[0]} x "
               f"{a[1].shape[0]} anchors")
    # the bench dock on 4 shards: the merge (D1) and shard 1's K12, K13 (D2)
    with recording(em, "pair_merge") as merges, \
            recording(em, "approx_repeat") as c12, \
            recording(em, "exact_repeat") as c13:
        docking.dock_structure(fit["map_set"], fit["sub_set"], fit["moved"],
                               fit["dmap"], cs.RES, cfg, verbose=False,
                               n_copies=cs.N_COPIES,
                               mesh=make_mesh(4, devices=[device] * 4))
    merge = [(f"mesh merge {r}", a) for r, a in enumerate(merges)]
    for label, a in merge:
        cs.say(f"K10 {label}: {a[0].shape[0]} keys into {a[1]}")
    d2 = [("shard 1", (c12[1], c13[1]))]
    cs.say(f"D2 shard 1: K12 on {c12[1][-3].shape[0]} pairs, K13 on "
           f"{c13[1][2].shape[0]} rows x {c13[1][0].shape[0]} x "
           f"{c13[1][1].shape[0]} anchors")
    match = (fit["map_set"], fit["sub_set"], tuple(fit["dmap"].shape),
             fit["dmap"].origin, fit["dmap"].voxsp, cfg.match,
             cfg.filter.n_samples * cs.N_COPIES)
    torch.save({"K13": k13, "K10": k10, "K10 merge": merge, "D2": d2,
                "K8": k8,
                "K21": k21, "match": match}, path)
    host_split(fit["map_set"], fit["sub_set"], cfg.match)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    groups = set(args.variants.split(",")) - {""}
    here = ((PATHS if "paths" in groups else ())
            + (PAIRS if "pairs" in groups else ())
            + (REPEAT if "repeat" in groups else ())
            + (SELECT if "select" in groups else ())
            + (GATHER if "gather" in groups else ()))
    variants = {"A": () if args.parent else here, "B": here}
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from mad_tpu_torch.kernels import build
    from torch_refine_describe_probe import same_bits
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(build.BUILD_DIR / "probe_match_inputs.pt")
    record(cs, path)
    torch.cuda.empty_cache()
    dirs = {"A": args.parent or ROOT, "B": ROOT}
    order = args.order if args.parent else "A"
    outs, times = {}, {"A": [], "B": []}
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    for i, side in enumerate(order):
        root = os.path.abspath(dirs[side])
        out = str(build.BUILD_DIR / f"probe_match_out_{side}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD,
             os.path.join(ROOT, "chip_smoke.py"), path, out, json.dumps(
                 variants[side] if order.index(side) == i else ()),
             json.dumps(_CLOCK_PHASES)],
            cwd=root, env=env, capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"run {i} ({side}, {root}) failed")
        res = json.loads(line[0][7:])
        times[side].append(res)
        print(f"run {i} {side} ({root}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in res.items()), flush=True)
        outs.setdefault(side, torch.load(out, weights_only=False))
    if len(outs) == 2:
        for key, a in outs["A"].items():
            b = outs["B"][key]
            same = all(same_bits(x, y) for x, y in zip(a, b))
            print(f"{key}: A and B " + ("equal bit for bit" if same
                                         else "DIFFER"), flush=True)
            cs.check(same, f"{key} differs between the checkouts")
    for side in "AB":
        runs = times[side]
        if runs:
            print(f"mean {side} over {len(runs)} runs: " + ", ".join(
                f"{k} {sum(r[k] for r in runs) / len(runs):.4f}"
                for k in runs[0] if k in runs[-1]), flush=True)


if __name__ == "__main__":
    main()
