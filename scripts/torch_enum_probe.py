#!/usr/bin/env python3
"""K19 and K20 (the assembly enumeration heads, csrc/enumerate.cu) on one
NVIDIA card: two checkouts' heads held bit for bit and timed in turns, and
builds of a checkout's source with lines changed.

    python3 scripts/torch_enum_probe.py [--parent DIR] [--order ABBA]
        [--variants split,tiles,clock]

The inputs, made here from seeds and saved under mad_tpu_torch/_build/:
K19 at the fit's shape (C(16, 10) ranks, head 256, a tie-heavy overlap as
tests/test_torch_assemble_cuda.py makes it) and at C(25, 6) (head 16);
K20 at chip_smoke.hetero_problem() (16^5 tuples over 80 solutions, head
256) and on falling sums (16^4 tuples, lists in solution order, an overlap
falling with the index). For every letter of ``--order`` (A the checkout
``--parent``, B this one; this one alone, once, without ``--parent``), one
process in that checkout runs its own wrappers on them and times each
head alone (chip_smoke.bare / kernel_ms: the wrapper's one launcher call
repeated on its buffers, the stream held while the host enqueues 20) and
its wrapper (chip_smoke.cuda_ms, mean of ten), and the heteromer phase
(engine/assemble.enumerate_heteromer on hetero_problem(), host clock to a
synchronize, median of seven after a warm call). The two checkouts' heads
are held equal bit for bit, and equal to the plain versions, and each
launch of a wrapper's call is timed by the profiler (device time, mean of
ten calls).
``--variants`` builds edited copies of the checkout's csrc/enumerate.cu,
all at once, in each side's first process, and times each alone on the
same recorded launcher calls (its heads held equal to the unedited ones
where the variant computes them whole):
  * split: A's heads (the former form: batched bitonic sorts) without
    their second launch (reduce_heads: one block reducing blocks x head
    keys); B's without their final head, with their blocks reading no
    global threshold word (each its own threshold only), with a hash of
    the rank for a key (no scorer: what the selects, staging and
    launches cost), and with a warp's keys of one bin counted by one
    atomic (__match_any_sync) in the selects;
  * tiles: B with one and with four ranks a thread a tile, and a room of
    two tiles in place of four;
  * clock: B with %globaltimer read at the phases of the first launch's
    block 0 (staging, tiles, the selects among them, the last select,
    the writes) and of the final head's first CTA (reads, its select, the
    gather and the second select, the sort), printed in ms (the variant
    writes them in place of the head).
Prints the card's name and power limit first. Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in a checkout (cwd), its mad_tpu_torch; the helpers (bare,
# kernel_ms, cuda_ms) from this checkout's chip_smoke, loaded by path.
CHILD = r"""
import ctypes, importlib.util, json, re, statistics, subprocess, sys, time
import numpy as np, torch
from mad_tpu_torch.engine import assemble as asm
from mad_tpu_torch.kernels import build, enumerate as k_enum, hetero
smoke, inputs, out_path, variants = (sys.argv[1], sys.argv[2], sys.argv[3],
                                     json.loads(sys.argv[4]))
spec = importlib.util.spec_from_file_location("smoke_helpers", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
device, _smi = cs.device_phase()
cs.build_phase()
procs = []
for name, edits in variants:
    text = (build.CSRC / "enumerate.cu").read_text()
    for old, new in edits:
        cs.check(len(re.findall(old, text, re.S)) == 1,
                 f"csrc/enumerate.cu has no single {old!r}")
        text = re.sub(old, new, text, flags=re.S)
    stem = "probe_enum_" + "".join(c if c.isalnum() else "_" for c in name)
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
inp = torch.load(inputs, weights_only=False)
res, outs = {}, {}
for key, (kind, a) in inp["cases"].items():
    if kind == "K19":
        ov, tab, head = a
        args = (ov.to(device), tab.to(device), head)
        fn, plain = k_enum.enumerate_head, k_enum.enumerate_head_plain
    else:
        ov, lists, sizes, head = a
        args = (ov.to(device), lists.to(device), sizes, head)
        fn, plain = hetero.hetero_head, hetero.hetero_head_plain
    got = fn(*args)
    cs.check(torch.equal(got, plain(*args)), f"{key}: differs from plain")
    outs[key] = got.cpu()
    r = cs.bare(lambda: fn(*args))
    res[key + " alone"] = cs.kernel_ms(r)
    res[key + " wrapper"] = cs.cuda_ms(lambda: fn(*args), reps=10)
    out_buf = [t for t in r.kept if torch.is_tensor(t) and t.is_cuda
               and t.data_ptr() == r.call[-1]]
    # the device time of each launch of the wrapper's call (profiler)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0 and e.count:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].strip()[:40]
            res[f"{key} device {name} ms"] = t / e.count / 1e3
    for name, lib in built:
        export = r.call[0].__name__
        vfn = getattr(lib, export)
        vfn.argtypes = build.SIGNATURES[export]
        vfn.restype = ctypes.c_int
        launch = lambda: build.launch(vfn, *r.call[1:])
        try:
            launch()
            torch.cuda.synchronize()
        except RuntimeError as err:          # reported, not fatal
            print(f"{key} {name}: {err}", flush=True)
            continue
        if name.startswith("clock") and out_buf:
            ns = out_buf[0][:13].cpu().tolist()
            for i, label in enumerate(json.loads(sys.argv[5])):
                if label:
                    res[f"{key} {label} (block 0) ms"] = (
                        ns[i] if "count" in label else ns[i] / 1e6)
        elif "alone" not in name and "without" not in name and out_buf:
            same = torch.equal(out_buf[0][:len(got)].cpu(), outs[key])
            cs.check(same, f"{key}: variant {name} differs")
        res[f"{key} {name} alone"] = cs.kernel_ms(launch)
ov, groups = cs.hetero_problem()
phase = lambda: asm.enumerate_heteromer(groups, ov, device=device)
phase()
walls = []
for _ in range(7):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = phase()
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
asm.pop_enum_notes()
res["heteromer phase ms"] = statistics.median(walls)
outs["heteromer tuples"] = torch.as_tensor(got[0])
torch.save(outs, out_path)
print("RESULT " + json.dumps(res), flush=True)
"""

# (name, [(regex, replacement)]) edits of csrc/enumerate.cu
SPLIT_A = (("first launch alone (without reduce_heads)", [(
    r"key_head<<<1, kThreads, bytes, stream>>>\(\s*partial, "
    r"static_cast<long long>\(blocks\) \* head, head, S, out\);", "")]),)
SPLIT_B = (
    ("first launch alone (without the final head)", [(
        r"return final_launch\(s, blocks, head, out, stream\);",
        "return 0;")]),
    ("no global word", [(
        r"s_tau = min\(s_own, word\);", "s_tau = s_own;")]),
    ("hashed rank keys (without the scorer)", [(
        r"key\[e\] = r < total \? src\(static_cast<unsigned>\(r\)\) : kNone;",
        "key[e] = r < total ? (static_cast<u64>(static_cast<unsigned>(r) * "
        "2654435761u) << 32) | static_cast<unsigned>(r) : kNone;")]),
    ("warp-aggregated counts", [(
        r"if \(\(x & mask\) == prefix\) atomicAdd\(&st\.bins\[\(x >> "
        r"shift\) & digit\], 1\);",
        "const int bin = (x & mask) == prefix ? static_cast<int>((x >> "
        "shift) & digit) : -1; const unsigned same = __match_any_sync("
        "__activemask(), bin); if (bin >= 0 && (threadIdx.x & 31) == "
        "__ffs(same) - 1) atomicAdd(&st.bins[bin], __popc(same));")]))
# "clock": %globaltimer at the phases of block 0 of the first launch and
# of the final head's first CTA, written to out (the final head's sorted
# head goes past them, over the kept keys it has read); the probe prints
# them in place of the head
CLOCK = (("clock (without the output)", [
    (r"typedef unsigned long long u64;\n",
     "typedef unsigned long long u64;\n__device__ __forceinline__ u64 "
     "mad_clock() { u64 t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
     "\"=l\"(t)); return t; }\n__shared__ u64 mad_t[8];\n"),
    (r"  __shared__ int s_nf;\n",
     "  __shared__ int s_nf;\n  if (threadIdx.x == 0) mad_t[0] = "
     "mad_clock();\n"),
    (r"  Radix\* s_radix = reinterpret_cast<Radix\*>\(tmp \+ "
     r"pow2_at_least\(head\)\);\n",
     "  Radix* s_radix = reinterpret_cast<Radix*>(tmp + pow2_at_least(head));"
     "\n  if (threadIdx.x == 0) mad_t[0] = mad_clock();\n"),
    (r"    s_own = kNone;\n  \}\n",
     "    s_own = kNone;\n  }\n  if (tid == 0) { mad_t[1] = mad_clock(); "
     "mad_t[5] = 0; mad_t[6] = 0; }\n"),
    (r"    const int n = s_n;\n    if \(tid == 0\) \{\n      st\.n = 0;",
     "    const u64 mad_r = mad_clock();\n    const int n = s_n;\n    if "
     "(tid == 0) {\n      st.n = 0;"),
    (r"      if \(thr != nullptr\) atomicMin\(thr, st\.tmax\);\n    \}\n"
     r"    __syncthreads\(\);\n  \};",
     "      if (thr != nullptr) atomicMin(thr, st.tmax);\n      mad_t[5] += "
     "mad_clock() - mad_r; mad_t[6] += 1;\n    }\n    __syncthreads();\n"
     "  };"),
    (r"  __syncthreads\(\);\n  if \(s_n > head\) reduce\(\);",
     "  __syncthreads();\n  if (tid == 0) mad_t[2] = mad_clock();\n  if "
     "(s_n > head) reduce();"),
    (r"  const int n = s_n;\n  if \(gridDim\.x == 1\) \{",
     "  if (tid == 0) mad_t[3] = mad_clock();\n  const int n = s_n;\n  if "
     "(gridDim.x == 1) {"),
    (r"  if \(tid == 0\) counts\[blockIdx\.x\] = n;\n\}",
     "  if (tid == 0) counts[blockIdx.x] = n;\n  __syncthreads();\n  if "
     "(blockIdx.x == 0 && tid == 0) { const u64 e = mad_clock(); out[0] = "
     "mad_t[1] - mad_t[0]; out[1] = mad_t[2] - mad_t[1]; out[2] = mad_t[5];"
     " out[3] = mad_t[6]; out[4] = mad_t[3] - mad_t[2]; out[5] = e - "
     "mad_t[3]; out[6] = e - mad_t[0]; }\n}"),
    (r"    s_sel = 0;\n  \}\n",
     "    s_sel = 0;\n  }\n  const u64 mad_f0 = mad_clock();\n"),
    (r"  __syncthreads\(\);\n  int n = s_n;\n",
     "  __syncthreads();\n  int n = s_n;\n  const u64 mad_f1 = mad_clock();"
     "\n"),
    (r"  compact<kFinalThreads>\(keys, n, mask, prefix, sel, gathered, "
     r"nullptr\);",
     "  const u64 mad_f2 = mad_clock();\n  compact<kFinalThreads>(keys, n, "
     "mask, prefix, sel, gathered, nullptr);"),
    (r"  sort_out<kFinalThreads>\(sel, n, out\);\n\}",
     "  const u64 mad_f3 = mad_clock();\n  sort_out<kFinalThreads>(sel, n, "
     "out + head);\n  __syncthreads();\n  if (tid == 0) { const u64 e = "
     "mad_clock(); out[8] = mad_f1 - mad_f0; out[9] = mad_f2 - mad_f1; "
     "out[10] = mad_f3 - mad_f2; out[11] = e - mad_f3; out[12] = e - "
     "mad_f0; }\n}"),
]),)
CLOCK_NAMES = ("staging", "tiles (selects in them too)", "selects in the tiles",
               "selects in the tiles (count)", "last select", "writes",
               "first launch", "", "final: reads", "final: local select",
               "final: gather and second select", "final: sort",
               "final head")

TILES = (
    ("one rank a thread a tile", [(r"kPer = 2;", "kPer = 1;")]),
    ("four ranks a thread a tile", [(r"kPer = 2;", "kPer = 4;")]),
    ("a room of two tiles", [(r"kRoom = 4 \* kTile;", "kRoom = 2 * kTile;")]))


def inputs(cs, path):
    import numpy as np
    import torch
    from mad_tpu_torch.kernels import enumerate as k_enum

    def ties(n, seed):
        rng = np.random.default_rng(seed)
        ov = np.where(rng.random((n, n)) < 0.35,
                      rng.integers(1, 3, (n, n)) * 0.1, 0.0)
        return torch.as_tensor(np.triu(ov, k=1), dtype=torch.float32)

    def k19(n, k, head, seed):
        return ("K19", (ties(n, seed), torch.as_tensor(
            k_enum.comb_table(n, k)), head))

    ov, groups = cs.hetero_problem()
    lists = torch.as_tensor(np.asarray(list(groups.values())),
                            dtype=torch.int32)
    i = np.arange(64)
    falling = np.triu(1.0 / (1.0 + i[:, None] + i[None, :]), k=1)
    cases = {
        "K19 C(16,10) head 256": k19(16, 10, 256, 26),
        "K19 C(25,6) head 16": k19(25, 6, 16, 31),
        "K20 16^5 head 256": ("K20", (
            torch.as_tensor(ov, dtype=torch.float32), lists,
            [len(g) for g in groups.values()], 256)),
        "K20 falling 16^4 head 256": ("K20", (
            torch.as_tensor(falling, dtype=torch.float32),
            torch.arange(64, dtype=torch.int32).reshape(4, 16), [16] * 4,
            256)),
    }
    torch.save({"cases": cases}, path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    groups = set(args.variants.split(",")) - {""}
    sides = {"A": (SPLIT_A if "split" in groups else ()),
             "B": ((SPLIT_B if "split" in groups else ())
                   + (TILES if "tiles" in groups else ())
                   + (CLOCK if "clock" in groups else ()))}
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch
    from mad_tpu_torch.kernels import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(build.BUILD_DIR / "probe_enum_inputs.pt")
    inputs(cs, path)
    dirs = {"A": args.parent or ROOT, "B": ROOT}
    order = args.order if args.parent else "B"
    outs, times = {}, {"A": [], "B": []}
    for i, side in enumerate(order):
        root = os.path.abspath(dirs[side])
        out = str(build.BUILD_DIR / f"probe_enum_out_{side}.pt")
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.join(ROOT, "chip_smoke.py"),
             path, out, json.dumps(sides[side] if order.index(side) == i
                                   else ()), json.dumps(CLOCK_NAMES)],
            cwd=root, capture_output=True, text=True)
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
            same = torch.equal(a, outs["B"][key])
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
