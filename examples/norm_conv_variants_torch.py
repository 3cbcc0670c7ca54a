"""Time design variants of B5's forward and B4's and B5's adjoints on the card.

Builds each variant of ``csrc/rms_norm.cu`` and ``csrc/causal_conv1d.cu``
(the committed source with a few constants replaced) into its own library,
binds it in place of the committed one, checks B5's forward against its
plain version bit for bit and every adjoint against its plain version
(within ``chip_smoke.norm_adj_tol``) and times each one's kernels on the
device (``kernel_split``, the profiler) in turns: variants in order, then
back. Shapes: B5's forward at mamba2-1.3b's and jamba-1.5-large's training
shapes, its decode step and 8 and 64 steps with a state (a segment, a
tile); mamba2-1.3b's training shape for the convolution's adjoint and the
gated norm, the plain norm at mamba2's 2048, phi4-mini's 3072 and
olmoe-1b-7b's 128-wide q/k rows.

Variants (``diag_`` ones change what is computed, to see what the time
goes to: they are timed, not held to the plain versions):

* ``base``: the committed sources;
* ``fwd_window``: B5's forward on the register-window kernel's 8-byte
  route where the staged kernel would run (the route a host-side choice);
* ``fwd_exact_silu``: the staged forward's bf16 SiLU the exact chain alone;
* ``fwd_lane16``: a lane 16 bytes (chunks of 512 bytes);
* ``fwd_4blocks``: four blocks an SM (64 registers);
* ``fwd_2blocks``: the staged forward held to two blocks an SM (up to 128
  registers);
* ``fwd_stages1``, ``fwd_stages3``: one stage in its ring, or three (two
  blocks an SM);
* ``fwd_warps4``: tiles of 32 steps (four warps), six blocks an SM;
* ``norm_stages3``: three rows in the norm adjoint's cp.async ring, not two;
* ``norm_half_grid``: the norm adjoint on half its resident blocks (half the
  partial rows);
* ``norm_block256``: the norm adjoint's blocks of 256 threads where rows take
  fewer (half the rows a block, twice the blocks and partial rows);
* ``conv_stages3``: three stages in the convolution adjoint's TMA ring;
* ``conv_4blocks``: the convolution adjoint held to four blocks an SM (64
  registers, where it spills);
* ``diag_norm_no_acc``: no dscale accumulation;
* ``diag_norm_no_sum``: no row sum (no barrier a row);
* ``diag_conv_no_sigmoid``: SiLU's derivative at a constant sigmoid;
* ``diag_conv_no_dx``: dx computed, not stored;
* ``diag_fwd_no_silu``: the staged forward's SiLU left out (the
  pre-activation stored: SiLU at no cost);
* ``diag_fwd_no_store``: its output computed, not stored;
* ``diag_fwd_loads_only``: its tiles loaded and read, nothing computed or
  stored.

Usage, on a machine with the card and ``nvcc`` (naming variants times
``base`` and those alone; ``--cases TEXT`` the cases whose label holds it):
    PYTHONPATH=src python examples/norm_conv_variants_torch.py [variant ...] [--cases TEXT]
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import emit, kernel_split, norm_adj_tol, ptxas_by_function, rel_norm  # noqa: E402
from repro_torch.kernels import causal_conv as cc  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402
from repro_torch.kernels.build import CSRC, NVCC_FLAGS, NVCC_INCLUDES, _nvcc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "norm_conv_variants"
FWD_STORE = "if (k < own) store_words<LW>(out + k * C, o);"
FWD_PRE = "unpack<T>(pre_word<T, W>(xw[q], ww[q], bw[q]), f);"
FWD_SILU = "const float r = silu_fast(f[e]);"
VARIANTS = {
    "base": {},
    "fwd_window": {},
    "fwd_exact_silu": {"causal_conv1d": [("constexpr bool FAST = sizeof(T) == 2;",
                                          "constexpr bool FAST = false;")]},
    "fwd_lane16": {"causal_conv1d": [("constexpr int FWD_ROW_BYTES = 256;",
                                      "constexpr int FWD_ROW_BYTES = 512;")]},
    "fwd_2blocks": {"causal_conv1d": [("constexpr int FWD_MIN_BLOCKS = 3;",
                                       "constexpr int FWD_MIN_BLOCKS = 2;")]},
    "fwd_stages1": {"causal_conv1d": [("constexpr int FWD_STAGES = 2;",
                                       "constexpr int FWD_STAGES = 1;")]},
    "fwd_stages3": {"causal_conv1d": [("constexpr int FWD_STAGES = 2;",
                                       "constexpr int FWD_STAGES = 3;"),
                                      ("constexpr int FWD_MIN_BLOCKS = 3;",
                                       "constexpr int FWD_MIN_BLOCKS = 2;")]},
    "fwd_warps4": {"causal_conv1d": [("constexpr int FWD_WARPS = 8;",
                                      "constexpr int FWD_WARPS = 4;"),
                                     ("constexpr int FWD_MIN_BLOCKS = 3;",
                                      "constexpr int FWD_MIN_BLOCKS = 6;")]},
    "fwd_4blocks": {"causal_conv1d": [("constexpr int FWD_MIN_BLOCKS = 3;",
                                       "constexpr int FWD_MIN_BLOCKS = 4;")]},
    "diag_fwd_no_silu": {"causal_conv1d": [("constexpr bool FAST = sizeof(T) == 2;",
                                            "constexpr bool FAST = false;"),
                                           ("f[e] = silu_exact(f[e]);", "")]},
    "diag_fwd_no_store": {"causal_conv1d": [(FWD_STORE, "if (o[0] == 0x12345u) " + FWD_STORE)]},
    "diag_fwd_loads_only": {"causal_conv1d": [
        ("constexpr bool FAST = sizeof(T) == 2;", "constexpr bool FAST = false;"),
        ("f[e] = silu_exact(f[e]);", ""), (FWD_PRE, "unpack<T>(xw[q][W - 1], f);"),
        (FWD_STORE, "if (o[0] == 0x12345u) " + FWD_STORE)]},
    "norm_stages3": {"rms_norm": [("constexpr int BWD_STAGES = 2;",
                                   "constexpr int BWD_STAGES = 3;")]},
    "norm_half_grid": {},
    "norm_block256": {"rms_norm": [("constexpr int BWD_ROW_BLOCK = 512;",
                                    "constexpr int BWD_ROW_BLOCK = 256;")]},
    "conv_stages3": {"causal_conv1d": [("constexpr int NSTAGES = 2;",
                                        "constexpr int NSTAGES = 3;")]},
    "conv_4blocks": {"causal_conv1d": [("__launch_bounds__(WARPS * 32, 3)",
                                        "__launch_bounds__(WARPS * 32, 4)")]},
    "diag_norm_no_acc": {"rms_norm": [(
        "aq[j % Q] = __fadd_rn(aq[j % Q], __fmul_rn(gv, rnd<T>(__fmul_rn(xv, r))));", "")]},
    "diag_norm_no_sum": {"rms_norm": [(
        "dot = row_sum_group(dot, tpr, red, static_cast<int>(it & 1));", "")]},
    "diag_conv_no_sigmoid": {"causal_conv1d": [(
        "const float sg = __fdividef(1.0f, 1.0f + __expf(-pre[e]));", "const float sg = 0.5f;")]},
    "diag_conv_no_dx": {"causal_conv1d": [("*out_word = pack<T>(o);",
                                           "if (o[0] == 12345.0f) *out_word = pack<T>(o);")]},
}
# variants made on the host side: the norm adjoint's residency halved
HALF_GRID = ("norm_half_grid",)


def build_all():
    """Every variant's two libraries, all nvcc processes at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, edits in VARIANTS.items():
        for name in ("rms_norm", "causal_conv1d"):
            src = (CSRC / f"{name}.cu").read_text()
            for old, new in edits.get(name, []):
                if old not in src:
                    raise SystemExit(f"{tag}: {old!r} not in {name}.cu")
                src = src.replace(old, new)
            path = OUT / f"{name}_{tag}.cu"
            path.write_text(src)
            cmd = [_nvcc(), *NVCC_FLAGS, *NVCC_INCLUDES, "-o", str(path.with_suffix(".so")),
                   str(path)]
            procs[(tag, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for (tag, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {tag} {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}_{tag}.so"))
        libs[(tag, name)] = (rn if name == "rms_norm" else cc)._bind(lib)
        ptxas[(tag, name)] = {k[-60:]: v for k, v in ptxas_by_function(log).items()
                              if ("bwd" in k or "fwd_kernel" in k) and "sum" not in k}
    return libs, ptxas


REAL_RESIDENCY, REAL_PLAN = rn._bwd_residency, rn.bwd_plan
REAL_FWD_ROUTE, REAL_FWD_CHUNK = cc.fwd_route, cc.FWD_CHUNK_BYTES


def fwd_window_route(*a):
    route = REAL_FWD_ROUTE(*a)
    return "vector" if route == "staged" else route


def plan_block256(d, vector, esize, gated):
    nu, tpr, _ = REAL_PLAN(d, vector, esize, gated)
    return nu, tpr, tpr if tpr >= 256 else 256 // tpr * tpr


def use(libs, tag):
    rn._lib = lambda: libs[(tag, "rms_norm")]
    cc._lib = lambda: libs[(tag, "causal_conv1d")]
    REAL_RESIDENCY.cache_clear()
    cc._residency.cache_clear()
    cc._fwd_residency.cache_clear()
    cc._FWD_LAYOUTS.clear()
    cc.fwd_route = fwd_window_route if tag == "fwd_window" else REAL_FWD_ROUTE
    cc.FWD_CHUNK_BYTES = 512 if tag == "fwd_lane16" else REAL_FWD_CHUNK    # fwd_plan's units
    rn._bwd_residency = ((lambda *a: max(1, REAL_RESIDENCY(*a) // 2)) if tag in HALF_GRID
                         else REAL_RESIDENCY)
    rn.bwd_plan = plan_block256 if tag == "norm_block256" else REAL_PLAN


def randn(shape, gen, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def cases(gen):
    """(label, call, plain, names, kernels of a call): B5's forward (its
    names None: held bit for bit; both forward kernels counted, whichever
    route runs), then the adjoints."""
    out = []
    fwd_kernels = ("causal_conv_fwd_kernel", "causal_conv_fwd_window_kernel")
    for label, (fb, fs), fc, width, with_state in (
            ("mamba2-1.3b", (4, 1024), 4352, 8512, False),
            ("jamba-1.5-large-398b", (4, 1024), 16640, 33280, False),
            ("mamba2-1.3b decode", (4, 1), 4352, 8512, True),
            ("8 steps", (4, 8), 4352, 8512, True), ("64 steps", (4, 64), 4352, 8512, True)):
        fx = randn((fb, fs, width), gen)[..., fc - 256:2 * fc - 256]
        fa = (fx, randn((4, fc), gen, scale=0.5), randn((fc,), gen, scale=0.1),
              randn((fb, 3, fc), gen) if with_state else None)
        out.append((f"causal_conv1d_fwd {label}", lambda fa=fa: cc.causal_conv1d_fwd(*fa),
                    lambda fa=fa: cc.causal_conv1d_plain(*fa), None, fwd_kernels))
    b, s, c = 4, 1024, 4352
    x = randn((b, s, 8512), gen)[..., 3840:3840 + c]
    w, bias, g = randn((4, c), gen, scale=0.5), randn((c,), gen, scale=0.1), randn((b, s, c), gen)
    out += [("causal_conv1d_bwd mamba2-1.3b", lambda: cc.causal_conv1d_bwd(g, x, w, bias)[:3],
            lambda: cc.causal_conv1d_bwd_plain(g, x, w, bias)[:3], ("dx", "dw", "db"),
            ("causal_conv_bwd_kernel", "causal_conv_sum_partials"))]
    h, p = 64, 64
    d = h * p
    y = randn((b, h, s, p), gen).transpose(1, 2)
    xh = randn((b, s, d + 256), gen)[..., :d].reshape(b, s, h, p)
    z = randn((b, s, 2 * d + 320), gen)[..., :d]
    D, scale = randn((h,), gen, torch.float32), randn((d,), gen, scale=0.5) + 1
    _, rstd = rn.gated_rms_norm_fwd_plain(y, xh, D, z, scale, 1e-5, keep_rstd=True)
    gz = randn((b, s, d), gen)
    args = (gz, y, xh, D, z, scale, rstd)
    out.append(("gated_rms_norm_bwd mamba2-1.3b", lambda: rn.gated_rms_norm_bwd(*args),
                lambda: rn.gated_rms_norm_bwd_plain(*args), ("dy", "dxh", "dD", "dz", "dscale"),
                ("rms_norm_bwd_kernel", "norm_sum_partials")))
    for label, rows, pd in (("mamba2-1.3b", (4, 1024), 2048), ("phi4-mini-3.8b", (4, 1024), 3072),
                            ("olmoe-1b-7b q/k", (4, 1024 * 16), 128)):
        xx, sc = randn((*rows, pd), gen), randn((pd,), gen, scale=0.5) + 1
        _, r = rn.rms_norm_fwd_plain(xx, sc, 1e-5, keep_rstd=True)
        gg = randn(xx.shape, gen)
        a = (gg, xx, sc, r)
        out.append((f"rms_norm_bwd {label}", lambda a=a: rn.rms_norm_bwd(*a),
                    lambda a=a: rn.rms_norm_bwd_plain(*a), ("dx", "dscale"),
                    ("rms_norm_bwd_kernel", "norm_sum_partials")))
    return out


def fwd_or_split(fn, kernels):
    """The kernels' device ms a call; of B5's two forward kernels only the
    one that ran (a call launches one of them)."""
    if kernels[0] == "causal_conv_fwd_kernel":
        before = dict(cc.causal_conv1d_fwd.launches_by_route)
        fn()
        ran = [r for r, n in cc.causal_conv1d_fwd.launches_by_route.items() if n > before[r]]
        kernels = kernels[:1] if ran == ["staged"] else kernels[1:]
    return kernel_split(fn, {k: 1 for k in kernels}, calls=5).values()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    args, only = sys.argv[1:], ""
    if "--cases" in args:
        i = args.index("--cases")
        only, args = args[i + 1], args[:i] + args[i + 2:]
    if args:
        for tag in [t for t in VARIANTS if t != "base" and t not in args]:
            del VARIANTS[tag]
    libs, ptxas = build_all()
    emit({"phase": "build", "card": torch.cuda.get_device_name(0),
          "ptxas": {f"{t} {n}": v for (t, n), v in ptxas.items()}})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True
    tags = list(VARIANTS)
    for label, fn, plain, names, kernels in cases(gen):
        if only not in label:
            continue
        wants = plain()
        times = {t: [] for t in tags}
        for tag in tags + tags[::-1]:
            use(libs, tag)
            got = fn()
            if names is None:                # B5's forward: output and new state bit for bit
                errs = {n: bool(torch.equal(a.contiguous().view(torch.int16),
                                            b.contiguous().view(torch.int16)))
                        for n, a, b in zip(("out", "new_state"), got, wants)}
                good = all(errs.values()) or tag.startswith("diag_")
            else:
                errs = {n: rel_norm(a, b) for n, a, b in zip(names, got, wants)}
                good = all(errs[n] <= norm_adj_tol("bfloat16", b.numel())
                           for n, b in zip(names, wants)) or tag.startswith("diag_")
            ok &= good
            times[tag].append(sum(fwd_or_split(fn, kernels)))
            if not good:
                emit({"phase": "check", "case": label, "variant": tag, "rel_err": errs})
        emit({"phase": "time", "case": label, "kernel_ms": {t: min(v) for t, v in times.items()},
              "turns_ms": times})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
