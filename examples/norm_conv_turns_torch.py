"""B5's forward and B4's and B5's adjoints on the card, this checkout's
kernels in turns with another checkout's (a ``git archive`` of an earlier
commit), and the host time a call of the plain norm forward and of B5's
forward.

    PYTHONPATH=src python examples/norm_conv_turns_torch.py --other <checkout>

Loads ``<checkout>/src/repro_torch/kernels``' ``rms_norm`` and
``causal_conv`` under a package name of their own (so both checkouts'
wrappers live in one process), builds both checkouts' ``rms_norm.cu`` and
``causal_conv1d.cu``, and prints, as JSON lines:

* ``check``: B5's forward of both checkouts against its plain version bit
  for bit (output and new state, with the route this checkout took) at
  ``CONV_FWD``'s shapes: mamba2-1.3b's and jamba-1.5-large's training shapes
  and mamba2's decode step (the cache's state), x the x|B|C slice of the
  projection; each adjoint of both checkouts against its plain version
  (within ``chip_smoke.norm_adj_tol``) at mamba2-1.3b's training shapes
  (the convolution over the x|B|C slice of the projection, the gated norm
  with y in the SSD kernel's layout), the plain norm at mamba2's 2048,
  phi4-mini's 3072 and olmoe-1b-7b's 128-wide q/k rows;
* ``time``: B5's forward at each of ``CONV_FWD``'s shapes and each adjoint,
  timed in turns (CUDA events over whole calls: this, other, other, this,
  three rounds; each checkout's kernels' device time a call by the
  profiler) beside its bound by bytes, and, for the plain form,
  ``torch.add`` of g and x (one elementwise kernel of the same reads);
* ``host_us``: the host µs a call, back to back, of the plain norm forward
  at a decode step's rows (4 × 1 × 2048) beside ``F.rms_norm``, and of B5's
  forward at mamba2's decode step beside the other checkout's, each with
  the parts of a call (the layout's lookup, the outputs' allocation, the
  ctypes launch).
"""
import argparse
import importlib
import subprocess
import sys
import types
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (emit, host_ms_per_call, in_turns, kernel_split,  # noqa: E402
                        norm_adj_tol, rel_norm)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402
from repro_torch.launch.roofline import H100_HBM_BW as PEAK_BYTES  # noqa: E402

# (label, rows (B, S), width): the plain form's adjoint on the training paths
PLAIN = (("mamba2-1.3b", (4, 1024), 2048), ("phi4-mini-3.8b", (4, 1024), 3072),
         ("olmoe-1b-7b q/k", (4, 1024 * 16), 128))
# B5's forward: (label, (B, S), C, the projection's width, a state)
CONV_FWD = (("mamba2-1.3b", (4, 1024), 4352, 8512, False),
            ("jamba-1.5-large-398b", (4, 1024), 16640, 33280, False),
            ("mamba2-1.3b decode", (4, 1), 4352, 8512, True))
# each kernel's launches a call, by name: B5's forward by this checkout's
# route (the staged kernel, or the register window at a decode step) and in
# a checkout before the staged forward (its one kernel, named as the staged
# one is now); the adjoints' kernels (both checkouts use these names)
CONV_FWD_KERNELS = {"staged": {"causal_conv_fwd_kernel": 1},
                    "vector": {"causal_conv_fwd_window_kernel": 1}}
CONV_KERNELS = {"causal_conv_bwd_kernel": 1, "causal_conv_sum_partials": 1}
NORM_KERNELS = {"rms_norm_bwd_kernel": 1, "norm_sum_partials": 1}


def other_kernels(root: Path):
    """``rms_norm`` and ``causal_conv`` of the checkout at ``root``, imported
    as ``other_kernels.*`` (its package ``__init__`` not run)."""
    pkg = types.ModuleType("other_kernels")
    pkg.__path__ = [str(root / "src" / "repro_torch" / "kernels")]
    sys.modules["other_kernels"] = pkg
    mods = [importlib.import_module(f"other_kernels.{n}")
            for n in ("build", "rms_norm", "causal_conv")]
    mods[0].build(["rms_norm", "causal_conv1d"])
    return mods[1], mods[2]


def randn(shape, gen, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def close(names, got, want):
    errs = {n: rel_norm(a, w) for n, a, w in zip(names, got, want)}
    return errs, all(e <= norm_adj_tol("bfloat16", w.numel())
                     for e, w in zip(errs.values(), want))


def timed(label, this, other, nbytes, kernels, smi, other_kernels=None):
    t = in_turns(this, other, iters=30, rounds=3, warmup=2)
    bound = nbytes / PEAK_BYTES * 1e3
    dev = [sum(kernel_split(fn, ks, calls=5).values())
           for fn, ks in ((this, kernels), (other, other_kernels or kernels))]
    emit({"phase": "time", "kernel": label, "kernel_ms": dev[0], "other_kernel_ms": dev[1],
          "bound_ms": bound, "share_of_bound": bound / dev[0],
          "other_share_of_bound": bound / dev[1], "call_ms": min(t[0]),
          "other_call_ms": min(t[1]), "turns_ms": t, "smi": smi})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="the checkout to time against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build.build(["rms_norm", "causal_conv1d"])
    orn, occ = other_kernels(Path(args.other).resolve())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True

    # B5's forward, bit for bit, x the x|B|C slice of the projection
    fwd = {}
    for label, (fb, fs), fc, fwidth, with_state in CONV_FWD:
        fproj = randn((fb, fs, fwidth), gen)
        fx = fproj[..., fc - 256:2 * fc - 256]      # after z's d_inner = C - 2 · 128 columns
        fw, fbias = randn((4, fc), gen, scale=0.5), randn((fc,), gen, scale=0.1)
        fstate = randn((fb, 3, fc), gen) if with_state else None
        want, want_state = cc.causal_conv1d_plain(fx, fw, fbias, fstate)
        for who, mod in (("this", cc), ("other", occ)):
            before = dict(mod.causal_conv1d_fwd.launches_by_route)
            got, got_state = mod.causal_conv1d_fwd(fx, fw, fbias, fstate)
            took = {r: n - before[r] for r, n in mod.causal_conv1d_fwd.launches_by_route.items()}
            good = (torch.equal(got.view(torch.int16), want.view(torch.int16)) and
                    torch.equal(got_state.view(torch.int16),
                                want_state.contiguous().view(torch.int16)))
            emit({"phase": "check", "kernel": "causal_conv1d_fwd", "path": label,
                  "checkout": who, "bits_equal": good, "routes": took})
            ok &= good
        fwd[label] = (fx, fw, fbias, fstate)

    # B5 at mamba2-1.3b's training shape: x the x|B|C slice of the projection
    b, s, c, width = 4, 1024, 4352, 8512
    proj = randn((b, s, width), gen)
    x = proj[..., 4096 - 256:4096 - 256 + c]
    w, bias = randn((4, c), gen, scale=0.5), randn((c,), gen, scale=0.1)
    g = randn((b, s, c), gen)
    want = cc.causal_conv1d_bwd_plain(g, x, w, bias)[:3]
    conv = {}
    for who, mod in (("this", cc), ("other", occ)):
        errs, good = close(("dx", "dw", "db"), mod.causal_conv1d_bwd(g, x, w, bias)[:3], want)
        emit({"phase": "check", "kernel": "causal_conv1d_bwd", "checkout": who,
              "rel_err": errs, "ok": good})
        ok &= good
        conv[who] = lambda mod=mod: mod.causal_conv1d_bwd(g, x, w, bias)

    # B4, gated, mamba2-1.3b: y in the SSD kernel's layout, xh and z in place
    h, p = 64, 64
    d = h * p
    y = randn((b, h, s, p), gen).transpose(1, 2)
    xh = randn((b, s, d + 256), gen)[..., :d].reshape(b, s, h, p)
    z = randn((b, s, 2 * d + 320), gen)[..., :d]
    D, scale = randn((h,), gen, torch.float32), randn((d,), gen, scale=0.5) + 1
    _, rstd = rn.gated_rms_norm_fwd(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    gz = randn((b, s, d), gen)
    gated_args = (gz, y, xh, D, z, scale, rstd)
    want = rn.gated_rms_norm_bwd_plain(*gated_args)
    gated = {}
    for who, mod in (("this", rn), ("other", orn)):
        errs, good = close(("dy", "dxh", "dD", "dz", "dscale"),
                           mod.gated_rms_norm_bwd(*gated_args), want)
        emit({"phase": "check", "kernel": "gated_rms_norm_bwd", "checkout": who,
              "rel_err": errs, "ok": good})
        ok &= good
        gated[who] = lambda mod=mod: mod.gated_rms_norm_bwd(*gated_args)

    plain = {}
    for label, (pb, ps), pd in PLAIN:
        xx, sc = randn((pb, ps, pd), gen), randn((pd,), gen, scale=0.5) + 1
        _, r = rn.rms_norm_fwd(xx, sc, 1e-5, keep_rstd=True)
        gg = randn(xx.shape, gen)
        want = rn.rms_norm_bwd_plain(gg, xx, sc, r)
        for who, mod in (("this", rn), ("other", orn)):
            errs, good = close(("dx", "dscale"), mod.rms_norm_bwd(gg, xx, sc, r), want)
            emit({"phase": "check", "kernel": "rms_norm_bwd", "path": label, "checkout": who,
                  "rel_err": errs, "ok": good})
            ok &= good
        plain[label] = (gg, xx, sc, r)
    if not ok:
        return 1

    for label, (fx, fw, fbias, fstate) in fwd.items():
        (fb, fs, fc), nst = fx.shape, 0 if fstate is None else 3
        route = cc.fwd_route(fs, fc, 2, *fx.stride()[:2], 0)
        other_names = getattr(occ, "FWD_ROUTES", None) and CONV_FWD_KERNELS[route]
        timed(f"causal_conv1d_fwd {label}", lambda a=fwd[label]: cc.causal_conv1d_fwd(*a),
              lambda a=fwd[label]: occ.causal_conv1d_fwd(*a),
              (2 * fb * fs * fc + 5 * fc + 3 * fb * fc + nst * fb * fc) * 2,
              CONV_FWD_KERNELS[route], smi, other_names or {"causal_conv_fwd_kernel": 1})
    n = b * s * c
    timed("causal_conv1d_bwd", conv["this"], conv["other"], 3 * n * 2 + 10 * c * 2,
          CONV_KERNELS, smi)
    n = b * s * d
    timed("gated_rms_norm_bwd", gated["this"], gated["other"],
          7 * n * 2 + 2 * d * 2 + 8 * h + 4 * b * s, NORM_KERNELS, smi)
    for label, a in plain.items():
        rows, pd = a[1].numel() // a[1].shape[-1], a[1].shape[-1]
        timed(f"rms_norm_bwd {label}", lambda a=a: rn.rms_norm_bwd(*a),
              lambda a=a: orn.rms_norm_bwd(*a), 3 * rows * pd * 2 + 2 * pd * 2 + 4 * rows,
              NORM_KERNELS, smi)
        out = torch.empty_like(a[1])
        emit({"phase": "stream_yardstick", "path": label, "torch_add_kernel_ms": sum(kernel_split(
            lambda a=a, o=out: torch.add(a[0], a[1], out=o),
            {"vectorized_elementwise_kernel": 1}, calls=5).values())})

    # the plain forward's host time a call, back to back, against F.rms_norm,
    # at a decode step's rows (4 x 1 x 2048, contiguous)
    xx, sc = plain["mamba2-1.3b"][1][:, -1:].contiguous(), plain["mamba2-1.3b"][2]
    rows, d, rs, _, tpr, _, mode, _, dev = rn._fwd_layout(xx, sc)
    out = torch.empty_like(xx)
    lib, stream = rn._lib(), torch._C._cuda_getCurrentRawStream(dev)
    xp, sp, op = xx.data_ptr(), sc.data_ptr(), out.data_ptr()
    calls = {"rms_norm_fwd": lambda: rn.rms_norm_fwd(xx, sc, 1e-5),
             "rms_norm_fwd keep_rstd": lambda: rn.rms_norm_fwd(xx, sc, 1e-5, keep_rstd=True),
             "other rms_norm_fwd": lambda: orn.rms_norm_fwd(xx, sc, 1e-5),
             "F.rms_norm": lambda: F.rms_norm(xx, (xx.shape[-1],), sc, 1e-5),
             # what a call is made of: the layout's lookup, the output's
             # allocation, the launch through ctypes alone
             "part: layout lookup": lambda: rn._fwd_layout(xx, sc),
             "part: torch.empty": lambda: torch.empty(xx.shape, dtype=xx.dtype, device=xx.device),
             "part: ctypes launch": lambda: lib.rms_norm_fwd(mode, xp, None, None, None, None, sp,
                                                             op, None, rows, d, rs, 0, 0, None,
                                                             1e-5, tpr, stream)}
    host_turns(calls, list(xx.shape), smi)

    # B5's forward at mamba2's decode step, this checkout's against the other's
    fx, fw, fbias, fstate = fwd["mamba2-1.3b decode"]
    fb, fs, c, es, width, xsb, xss, grid, modes, dev = cc._fwd_layout(fx, fw, fbias, fstate)
    route = cc.fwd_route(fs, c, es, xsb, xss, 0)
    out, new_state = torch.empty_like(fx), torch.empty_like(fstate)
    clib = cc._lib()
    ptrs = (fx.data_ptr(), fstate.data_ptr(), fw.data_ptr(), fbias.data_ptr(), out.data_ptr(),
            new_state.data_ptr())
    host_turns({
        "causal_conv1d_fwd": lambda: cc.causal_conv1d_fwd(fx, fw, fbias, fstate),
        "other causal_conv1d_fwd": lambda: occ.causal_conv1d_fwd(fx, fw, fbias, fstate),
        "part: layout lookup": lambda: cc._fwd_layout(fx, fw, fbias, fstate),
        "part: new_empty x2": lambda: (fx.new_empty(fx.shape), fx.new_empty(fstate.shape)),
        f"part: ctypes launch ({route})": lambda: clib.causal_conv1d_fwd(
            modes[route], *ptrs, fb, fs, c, xsb, xss, grid, stream)}, list(fx.shape), smi)
    return 0


def host_turns(calls: dict, shape, smi) -> None:
    """Each call's host µs (``host_ms_per_call``, 400 calls back to back),
    in turns: in order, then back; the least of each."""
    host = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        host[k].append(host_ms_per_call(calls[k], calls=400) * 1e3)
    emit({"phase": "host_us", "shape": shape, "smi": smi, **{k: min(v) for k, v in host.items()}})


if __name__ == "__main__":
    sys.exit(main())
