#!/usr/bin/env python3
"""Time each launch of the int8 bottleneck kernels (`embodied_clip_tpu_torch/csrc/
bottleneck_int8.cu`: (a) 1×1, (b) 3×3, (c) cb3·cb1, (d) K3's entry, (e) the stride
blocks' conv shortcut, (f) the 2×2 pool, (f') the pool + scale of the stride blocks'
input, the shortcut's bf16 operand) on the main path, on one NVIDIA GPU.

    python3 tools/bench_int8_gemm.py [--source a.cu,b.cu]

The encoder is `clip_rn50`, random weights from seed 0, BN-folded and quantized on
golden_frames(32) (`bench.py`'s recipe); the frames are golden_frames(128). The tool

  * records every launch of one batch-128 encode on path A (K3 + K5 + the stride
    blocks) and on path B (K3 + K4 + the stride blocks up to cb3), and holds every
    K3/K4/K5 and stride-block call of both encodes to its plain version with the
    repository's library (K4/K5 bit-exact, K3 ≤1 s8 step on ≤0.5%, the stride block as
    `parity.stride_block_disagreement`: o8 and cb3 bit-exact, id8 ≤1 step on ≤0.5%);
  * for each kernel source (the repository's by default; `--source` builds other
    versions of the file with the same nvcc flags), prints nvcc's register and spill
    report of every kernel that spills or serializes its wgmmas (C7512), runs each
    distinct launch on its recorded inputs, checks its output against the repository
    library's (bit-equal; (d)'s shortcut output within K3's contract, its f32 sum order
    being the design's), and times it with CUDA events in turns (the sources in order,
    then in reverse; the least of the turns is kept); prints ms, TOP/s and the launch's
    bound (its s8 operations at the dense int8 peak and bf16 ones at the bf16 peak,
    against its bytes, each input, weight and output once, at the memory rate); beside
    each 1×1 launch `torch._int_mm` on the same (M, K) × (K, N), and beside (d) and (e)
    `torch.matmul` of the shortcut's bf16 product (f32 out, no requant), as yardsticks for
    the GEMM alone (the port never calls them);
  * sums the launches per encode by the path and the wrapper that made them (K3, K5
    and the stride blocks on path A; K3, K4 and the stride blocks on path B), and each
    stride-block launch kind over the three blocks.

A `--source` file must have the repository file's C interface (`BK.LIB_INT8`); an
older file is compared at the commit where it was measured.

Writes everything to chiprun_out/bench_int8_gemm.json. Exits non-zero without a CUDA
device, or when a source does not build or disagrees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

YARDSTICKS = {"a": "torch._int_mm", "d": "torch.matmul (bf16 shortcut)",
              "e": "torch.matmul (bf16 shortcut)"}
NAMES = {"a": "1x1", "b": "3x3", "c": "cb3·cb1", "d": "K3 entry", "e": "shortcut",
         "f": "2x2 pool", "f'": "pool + scale"}
# Card → (device-memory bytes/s, dense int8 operations/s, dense bf16 FLOP/s), NVIDIA data
# sheets.
CARDS = (("H100 PCIe", 2.0e12, 1513e12, 756e12), ("H100 NVL", 3.9e12, 1671e12, 835e12),
         ("H100", 3.35e12, 1979e12, 989e12), ("H200", 4.8e12, 1979e12, 989e12))


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Launch:
    """One recorded launch: its step, inputs, the wrapper that made it, and how to run
    it through a library (outputs and scratch allocated once)."""

    def __init__(self, step, args, kw, wrapper):
        import torch

        self.step, self.args, self.kw, self.wrapper = step, args, kw, wrapper
        x8 = args[0]
        if step == "d":
            ops = args[1]
            self.outs = tuple(torch.empty((*x8.shape[:-1], n), dtype=torch.int8,
                                          device=x8.device)
                              for n in (ops["k1a"].shape[-1], ops["wsc"].shape[-1]))
        elif step == "c":
            res8, k1t = args[1], args[5]
            self.outs = (torch.empty_like(res8),
                         torch.empty((*x8.shape[:-1], k1t.shape[0]), dtype=torch.int8,
                                     device=x8.device))
        elif step == "e":  # x8 is (f')'s x0 here
            self.outs = (torch.empty((*x8.shape[:-1], args[2]["wsc"].shape[-1]),
                                     dtype=torch.int8, device=x8.device),)
        elif step == "f'":
            n, h, w, c = x8.shape
            self.outs = (torch.empty((n, h // 2, w // 2, c), dtype=torch.bfloat16,
                                     device=x8.device),
                         torch.empty((n, h // 2, w // 2), dtype=torch.float32,
                                     device=x8.device))
        elif step == "f":
            n, h, w, c = x8.shape
            self.outs = (torch.empty((n, h // 2, w // 2, c), dtype=torch.int8,
                                     device=x8.device),)
        else:
            self.outs = (torch.empty_like(args[5]),)
        self.scratch = None

    def weight(self):
        """The K-major weight (cb3's for (c), cb1a's for (d)), (e)'s bf16 wsc; (f), (f')
        none."""
        if self.step == "d":
            return self.args[1]["k1a_t"]
        if self.step == "e":
            return self.args[2]["wsc"]
        if self.step in ("f", "f'"):
            return None
        return self.args[2] if self.step == "c" else self.args[1]

    def key(self):
        w = self.weight()
        return (self.step, tuple(self.args[0].shape), None if w is None else tuple(w.shape),
                self.kw.get("res") is not None, str(self.outs[0].dtype),
                tuple(self.args[5].shape) if self.step == "c" else None,
                bool(self.recip()))

    def recip(self):
        return self.args[4] if self.step == "e" else self.kw.get("recip", False)

    def shapes(self):
        x, w = self.args[0], self.weight()
        m = x.numel() // x.shape[-1]
        if self.step == "d":
            return m, (x.shape[-1], w.shape[0], self.args[1]["wsc"].shape[-1])  # (Cin, Cm, Cout)
        if self.step == "c":
            return m, (x.shape[-1], w.shape[0], self.args[5].shape[0])  # (Cm, C, C1)
        if self.step == "e":
            return m, tuple(w.shape)  # (Cin, Cout)
        if self.step in ("f", "f'"):
            return m, (x.shape[-1],)
        return m, (w.shape[1], w.shape[0])  # (K, N)

    def work(self):
        """(s8 operations, bf16 operations, bytes): 2 per multiply-add; each input, weight
        and output once."""
        m, dims = self.shapes()
        nbytes = sum(t.numel() * t.element_size() for t in self.outs) + self.args[0].numel()
        if self.step == "d":
            cin, cm, cout = dims
            return 2 * m * cin * cm, 2 * m * cin * cout, nbytes + cin * cm + 2 * cin * cout
        if self.step == "c":
            cm, c, c1 = dims
            return 2 * m * (cm * c + c * c1), 0, nbytes + m * c + cm * c + c * c1
        if self.step == "e":  # x0 (bf16) and its norms, wsc, its margins and bias, sc8
            cin, cout = dims
            return 0, 2 * m * cin * cout, nbytes + m * cin + 4 * m + 2 * cin * cout + 8 * cout
        if self.step in ("f", "f'"):
            return 0, 0, nbytes
        k, n = dims
        res = self.kw.get("res")
        return 2 * m * k * n, 0, nbytes + k * n + (res.numel() if res is not None else 0)

    def run(self, lib):
        """One launch through `lib` (`BK.LIB_INT8` or a variant of it) into self.outs."""
        import torch

        from embodied_clip_tpu_torch.ops.kernels._build import stream as stream_of

        dev = self.args[0].device
        stream = stream_of(self.args[0])
        if self.step == "d":
            x8, ops, r1, s_in, dsc = self.args
            m, (cin, cm, cout) = self.shapes()
            q1, sc8 = self.outs
            k1t, wsc = ops["k1a_t"], ops["wsc"]
            if self.scratch is None:  # the near-tie flag words
                self.scratch = torch.empty(lib.ect_stage1_entry_ties(m, cout),
                                           dtype=torch.int64, device=dev)
            lib.ect_stage1_entry(x8.data_ptr(), m, cin, k1t.data_ptr(), cm,
                                 ops["s1a"].data_ptr(), ops["b1a"].data_ptr(), r1,
                                 wsc.data_ptr(), cout, s_in, ops["bsc"].data_ptr(),
                                 dsc, q1.data_ptr(), sc8.data_ptr(),
                                 self.scratch.data_ptr(), *stream)
        elif self.step == "e":
            x0, rnorm, ops, dsc, recip = self.args
            m, (cin, cout) = self.shapes()
            if self.scratch is None:  # the near-tie flag words
                self.scratch = torch.empty(lib.ect_shortcut_ties(m, cout), dtype=torch.int64,
                                           device=dev)
            lib.ect_shortcut_s8(x0.data_ptr(), rnorm.data_ptr(), m, cin,
                                ops["wsc"].data_ptr(), ops["wsc_t"].data_ptr(), cout,
                                ops["wsc_m"].data_ptr(), ops["bsc"].data_ptr(), dsc,
                                self.outs[0].data_ptr(), self.scratch.data_ptr(),
                                int(recip), *stream)
        elif self.step == "f'":
            x8, s_in = self.args
            n, h, w, c = x8.shape
            lib.ect_pool2_scale_s8(x8.data_ptr(), n, h, w, c, s_in,
                                   self.outs[0].data_ptr(), self.outs[1].data_ptr(),
                                   *stream)
        elif self.step == "f":
            n, h, w, c = self.args[0].shape
            lib.ect_avg_pool2_s8(self.args[0].data_ptr(), n, h, w, c,
                                 self.outs[0].data_ptr(), *stream)
        elif self.step == "a":
            x8, kt, s, b, r_out, out = self.args
            res, r_res = self.kw.get("res"), self.kw.get("r_res_ptr")
            kind = 0 if res is None else {torch.int8: 1, torch.bfloat16: 2,
                                          torch.float32: 3}[out.dtype]
            lib.ect_conv1x1_s8(x8.data_ptr(), x8.numel() // x8.shape[-1], kt.shape[1],
                               kt.data_ptr(), kt.shape[0],
                               s.data_ptr(), b.data_ptr(),
                               0 if res is None else res.data_ptr(), r_res or 0, r_out,
                               self.outs[0].data_ptr(), kind,
                               int(self.kw.get("recip", False)), *stream)
        elif self.step == "b":
            x8, k2t, s, b, r_out, _ = self.args
            n, h, w, c = x8.shape
            lib.ect_conv3x3_s8(x8.data_ptr(), n, h, w, c, k2t.data_ptr(), k2t.shape[0],
                               s.data_ptr(), b.data_ptr(), r_out,
                               self.outs[0].data_ptr(),
                               int(self.kw.get("recip", False)), *stream)
        else:
            x8, res8, k3t, s3, b3, k1t, s1, b1, r_res, r_out, r_next = self.args
            m, (cm, c, c1) = self.shapes()
            lib.ect_cb3_cb1_s8(x8.data_ptr(), res8.data_ptr(), m, cm, c, c1,
                               k3t.data_ptr(), s3.data_ptr(), b3.data_ptr(),
                               k1t.data_ptr(), s1.data_ptr(), b1.data_ptr(), r_res, r_out,
                               r_next, self.outs[0].data_ptr(), self.outs[1].data_ptr(),
                               int(self.kw.get("recip_out", False))
                               | 2 * int(self.kw.get("recip_next", False)), *stream)


def record(BK, encoders, frames):
    """Every launch of one encode per path, tagged with its wrapper and path; and the
    wrapper calls, for the contract."""
    import torch

    launches, calls, current = [], [], {}
    steps = {"_conv1x1": "a", "_conv3x3": "b", "_cb3_cb1": "c", "_stage1_entry": "d",
             "_shortcut": "e", "_avg_pool2": "f", "_pool2_scale": "f'"}
    saved = {n: getattr(BK, n) for n in (*steps, "fused_stage1_int8", "fused_cb3_cb1_int8",
                                         "fused_resblocks_int8", "fused_stride_block_int8")}

    def launch_rec(name):
        def rec(*args, **kw):
            launches.append((current["path"], Launch(steps[name], args, kw, current["w"])))
            return saved[name](*args, **kw)
        return rec

    def wrapper_rec(name):
        def rec(*args, **kw):
            current["w"] = name
            calls.append((name, args, kw))
            return saved[name](*args, **kw)
        rec.launches = 0  # the wrapper counts its launches through the module's name
        return rec

    for name in saved:
        setattr(BK, name, launch_rec(name) if name in steps else wrapper_rec(name))
    try:
        for path, enc in encoders.items():
            current["path"] = path
            enc.encode(frames)
    finally:
        for name, fn in saved.items():
            setattr(BK, name, fn)
    torch.cuda.synchronize()
    return launches, calls


def agree(ln, want):
    """(ok, note): a launch's outputs against the repository library's, bit-equal; (d)'s
    shortcut output within K3's contract (≤1 step on ≤0.5%), since the f32 sum order of
    the shortcut is the design's."""
    import torch

    if ln.step != "d":
        same = all(torch.equal(g, w) for g, w in zip(ln.outs, want))
        return same, "bit-equal" if same else "DIFFERS from the repository's library"
    q1_same = torch.equal(ln.outs[0], want[0])
    d = (ln.outs[1].int() - want[1].int()).abs()
    step, share = int(d.max()), float((d != 0).float().mean())
    ok = q1_same and step <= 1 and share <= 0.005
    return ok, (f"q1 {'bit-equal' if q1_same else 'DIFFERS'}, sc8 {step} step on {share:.2e} "
                "against the repository's library")


def check_contract(BK, calls):
    """Every K3/K4/K5 and stride-block call against its plain version, as chip_smoke.py
    phase 5: (K4/K5 bit-exact and the stride block's o8 and cb3 bit-exact, the worst s8
    step and share of K3's output and the stride blocks' id8)."""
    import torch

    from embodied_clip_tpu_torch.parity import stride_block_disagreement

    exact, worst_step, worst_share = True, 0, 0.0
    for name, args, kw in calls:
        if name == "fused_stride_block_int8":
            r = stride_block_disagreement(*args, **kw)
            exact &= r["o8_equal"] and r["cb3_equal"] is not False
            worst_step = max(worst_step, r["id8_step"])
            worst_share = max(worst_share, r["id8_share"])
            continue
        got = getattr(BK, name)(*args, **kw)
        want = getattr(BK, name + "_reference")(*args, **kw)
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            if name == "fused_stage1_int8":
                d = (g.int() - w.int()).abs()
                worst_step = max(worst_step, int(d.max()))
                worst_share = max(worst_share, float((d != 0).float().mean()))
            else:
                exact &= torch.equal(g, w)
    torch.cuda.synchronize()
    return exact, worst_step, worst_share


def ptxas_report(log):
    """{kernel: "…"} from nvcc's `-Xptxas -v` output, for the kernels that spill or whose
    wgmmas ptxas serialized (C7512): registers, stack and spills."""
    import re

    def short(mangled):  # _ZN…_cu_<8 hex><len><name><template args>…
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
        if not m:
            return mangled
        n, rest = int(m.group(1)), mangled[m.end():]
        return rest[:n] + rest[n:].split("Ev", 1)[0]

    props, serialized, name = {}, set(), None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = short(line.split("for", 1)[1].strip())
            props[name] = []
        elif "(C7512)" in line:
            serialized.add(short(line.rsplit("function", 1)[-1].strip(" '.")))
        elif name and ("spill" in line or "Used" in line):
            props[name].append(line.split(":", 1)[-1].strip())
    def spills(lines):
        return any(int(m.group(1)) for t in lines
                   for m in [re.search(r"(\d+) bytes spill stores", t)] if m)

    return {k: "; ".join(v) + ("; wgmma serialized (C7512)" if k in serialized else "")
            for k, v in props.items() if k in serialized or spills(v)}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_int8_gemm: no CUDA device is available", file=sys.stderr)
        return 1
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.quantize import PATH_B
    from embodied_clip_tpu_torch.parity import golden_frames

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="", help="comma-separated .cu files to compare")
    opts = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _, bw, peak, bf16_peak = next((c for c in CARDS if c[0] in kind), CARDS[2])
    print(f"torch {torch.__version__} on {smi}")

    qenc = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cuda").fold_bn().quantize(
        golden_frames(32))
    frames = torch.from_numpy(golden_frames(128)).cuda()
    with torch.inference_mode():
        launches, calls = record(BK, {"A": qenc, "B": qenc.with_kernels(**PATH_B)}, frames)
        exact, step, share = check_contract(BK, calls)
    ok_all = exact and step <= 1 and share <= 0.005
    print(f"{len(calls)} K3/K4/K5 and stride-block calls vs plain: K4/K5 and the stride "
          f"blocks' o8 and cb3 {'bit-exact' if exact else 'DIFFER'}, K3 and the stride "
          f"blocks' id8 worst {step} step on {share:.2e}")

    # Distinct launches, with their count per encode of each path and wrapper.
    distinct = {}
    for path, ln in launches:
        entry = distinct.setdefault(ln.key(), {"launch": ln, "count": {}})
        tag = f"{path}:{ln.wrapper}"
        entry["count"][tag] = entry["count"].get(tag, 0) + 1
    repo_lib = BK.LIB_INT8
    with torch.inference_mode():
        for entry in distinct.values():  # the expected outputs: the repository's library
            ln = entry["launch"]
            ln.run(repo_lib)
            entry["want"] = [t.clone() for t in ln.outs]
            if ln.step == "a":
                x8, kt = ln.args[0], ln.args[1]
                a2 = x8.reshape(-1, x8.shape[-1])
                entry["yardstick_ms"] = cuda_ms(lambda: torch._int_mm(a2, kt.t()))
            elif ln.step == "d":  # the shortcut's bf16 product alone
                x8, ops = ln.args[0], ln.args[1]
                a16 = (x8.reshape(-1, x8.shape[-1]).float() * ops["scl"][0]).to(torch.bfloat16)
                entry["yardstick_ms"] = cuda_ms(lambda: torch.matmul(a16, ops["wsc"]))
            elif ln.step == "e":
                x0, wsc = ln.args[0], ln.args[2]["wsc"]
                a16 = x0.reshape(-1, x0.shape[-1])
                entry["yardstick_ms"] = cuda_ms(lambda: torch.matmul(a16, wsc))

    sources = opts.source.split(",") if opts.source else [str(_build.CSRC / "bottleneck_int8.cu")]
    libs, reports = {}, {}
    for path in sources:
        lib_path, log = _build.build_variant(path, "int8")
        libs[path], reports[path] = BK.LIB_INT8.variant(lib_path), ptxas_report(log)
        print(f"{path}: {len(reports[path])} kernel(s) spill or serialize their wgmmas")
        for k, v in reports[path].items():
            print(f"  {k}: {v}")
    times = {(path, key): [] for path in sources for key in distinct}
    notes = {}
    with torch.inference_mode():
        for path in sources + sources[::-1]:  # in turns
            for key, entry in distinct.items():
                ln = entry["launch"]
                ln.run(libs[path])
                torch.cuda.synchronize()
                same, note = agree(ln, entry["want"])
                ok_all &= same
                notes[path, key] = (same, note)
                times[path, key].append(cuda_ms(lambda: ln.run(libs[path])))
    results = []
    for path in sources:
        print(f"{path}:")
        rows, sums = [], {}
        for key, entry in distinct.items():
            ln = entry["launch"]
            ms = min(times[path, key])
            same, note = notes[path, key]
            ops8, ops16, nbytes = ln.work()
            ops_ms, bytes_ms = (ops8 / peak + ops16 / bf16_peak) * 1e3, nbytes / bw * 1e3
            b_ms = max(ops_ms, bytes_ms)
            w = ln.weight()
            row = {"step": ln.step, "x": list(ln.args[0].shape),
                   "w": None if w is None else list(w.shape), "out_dtype": key[4],
                   "residual": key[3], "recip": key[6], "count": entry["count"],
                   "gop": (ops8 + ops16) / 1e9, "mbytes": nbytes / 1e6, "ms": ms,
                   "ms_turns": times[path, key], "tops": (ops8 + ops16) / ms / 1e9,
                   "bound_ms": b_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                   "share_of_bound": b_ms / ms, "yardstick_ms": entry.get("yardstick_ms"),
                   "equal": same, "agreement": note}
            rows.append(row)
            for tag, n in entry["count"].items():
                for t in (tag, f"{tag} ({ln.step}) {NAMES[ln.step]}"
                          if tag.endswith("fused_stride_block_int8") else None):
                    if t is None:
                        continue
                    s = sums.setdefault(t, {"ms": 0.0, "bound_ms": 0.0, "launches": 0})
                    s["ms"] += n * ms
                    s["bound_ms"] += n * b_ms
                    s["launches"] += n
            print(f"  ({ln.step}) x {tuple(ln.args[0].shape)}"
                  + (f" w {tuple(w.shape)}" if w is not None else "")
                  + (f" k1t {key[5]}" if key[5] else "")
                  + f"{' +res' if key[3] else ''} {key[4]} ×{entry['count']}: {ms:.4f} ms "
                  f"(turns {', '.join(f'{t:.4f}' for t in times[path, key])}; "
                  f"{row['tops']:.0f} TOP/s, {row['share_of_bound']:.1%} of the bound "
                  f"{b_ms:.4f} ms by {row['bound_by']})"
                  + (f"; {YARDSTICKS[ln.step]} {row['yardstick_ms']:.4f} ms"
                     if ln.step in YARDSTICKS else "")
                  + f"; {note}")
        for tag, s in sorted(sums.items()):
            print(f"  per encode, path {tag}: {s['launches']} launches, {s['ms']:.4f} ms "
                  f"against launch bounds of {s['bound_ms']:.4f} ms; on {smi}")
        results.append({"source": path, "ptxas": reports[path], "rows": rows,
                        "per_encode": sums})
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_int8_gemm.json", "w") as f:
        json.dump({"card": smi, "torch": torch.__version__,
                   "contract": {"k4_k5_stride_o8_cb3_bit_exact": exact, "worst_step": step,
                                "worst_share": share},
                   "results": results}, f, indent=1)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
