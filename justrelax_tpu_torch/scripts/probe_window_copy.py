"""Where the time of R (the 2D dynamic-window copy) goes on the card: the
kernel beside the copies that bound it, by the card's time per call.

    python -m justrelax_tpu_torch.scripts.probe_window_copy [--parent DIR]
        [--rows 1,2,4,8] [--tma-rows 1,2,4,8] [--reps 20] [--repeats 7]

Run from the root of a checkout, on a machine with a CUDA card. At the
repro script's shape (float32 (4, 64, 64, 128) into (1, 64, 64, 128)), in
each mode, it times by ``chip_smoke.device_time_ms`` (the card's time per
call, the host's beside it):

- ``kernel``: ``hopper_window_copy.window_copy``, this tree's R (TMA copies,
  ``plan``'s cut: one x row a block at this shape);
- ``tma_rows{r}``: the same kernel with ``r`` x rows a block (``--tma-rows``,
  where the block's shared memory allows it);
- ``parent``: the parent tree's R (``--parent DIR``, a parent commit's
  ``justrelax_tpu_torch/ops`` and ``csrc``, e.g. from ``git archive``);
- ``direct_rows{r}``: a plain 16-byte vectorised global-to-global copy over
  a grid of one block per ``r`` x rows of a window (the CUDA kernel below,
  appended to ``csrc/window_copy.cu`` and built with it; nothing in the
  package calls it);
- ``plain``: ``window_copy_reference`` (index arithmetic and one gather);
- ``gather``: the one indexing call ``src[0][xi[:, None], yi[None, :]]``,
  its indices built before;
- ``floor``: ``out.copy_(src[0])``, one device-to-device copy of the same
  2 MiB.

Each runs on one input (its 4 MiB of traffic stays in the 50 MB L2 cache:
"warm") and on 32 inputs in turn (64 MiB of plane-0 sources: "cold"), in
turns forward and back. Every variant's output is held bit-equal to the
plain version's first. Prints one JSON line per mode and variant.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import json
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from justrelax_tpu_torch.ops import _cuda_build
from justrelax_tpu_torch.ops import hopper_window_copy as hw
from justrelax_tpu_torch.scripts import repro_2d_dma as rp

PROBE_CU = r"""
namespace {
// One block per `rows` x rows of window (i, j): each thread copies 16-byte
// pieces straight from the source rows to the output rows (mode 1 has no y
// offset; modes 0 and 2 copy the same window).
__global__ void __launch_bounds__(128) k_probe_direct(
    const float4* __restrict__ src, float4* __restrict__ out, int X, int Y, int Z4,
    int W, int Wy, int R, int Ry, int rows, int mode) {
  const int xr = blockIdx.x * rows, j = blockIdx.y;
  const int i = xr / R, a0 = xr - i * R;
  const int x0 = min(max(i * R - 4, 0), X - W);
  const int y0 = mode == 1 ? 0 : min(max(j * Ry - 4, 0), Y - Wy);
  const int per_a = Ry * Z4;
  for (int p = threadIdx.x; p < rows * per_a; p += blockDim.x) {
    const int a = p / per_a, k = p - a * per_a;
    out[((long long)(xr + a) * Y + j * Ry) * Z4 + k] =
        src[((long long)(x0 + a0 + a) * Y + y0) * Z4 + k];
  }
}
}  // namespace

extern "C" int jr_window_copy_direct_f32(const void* src, void* out, int X, int Y, int Z,
                                         int W, int Wy, int R, int Ry, int rows, int mode,
                                         void* stream) {
  k_probe_direct<<<dim3(X / rows, Y / Ry), 128, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(src), static_cast<float4*>(out), X, Y, Z / 4, W, Wy, R,
      Ry, rows, mode);
  return (int)cudaGetLastError();
}
"""

GEOM = dict(W=rp.W, Wy=rp.Wy, R=rp.R, Ry=rp.Ry)
MODE_CODE = {"2d": 0, "x": 1, "loop": 2}


@functools.lru_cache(maxsize=None)
def probe_library():
    """``csrc/window_copy.cu`` with the direct copy appended, built once."""
    src = _cuda_build._BUILD_DIR / "probe_window_copy.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(hw.SOURCE.read_text() + PROBE_CU)
    lib = _cuda_build.load_library(src)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.jr_window_copy_direct_f32.argtypes = [vp, vp] + [i] * 9 + [vp]
    lib.jr_window_copy_direct_f32.restype = i
    return lib


def direct(src, mode, rows):
    _, X, Y, Z = src.shape
    out = torch.empty((1, X, Y, Z), dtype=src.dtype, device=src.device)
    err = probe_library().jr_window_copy_direct_f32(
        src.data_ptr(), out.data_ptr(), X, Y, Z, GEOM["W"], GEOM["Wy"], GEOM["R"],
        GEOM["Ry"], rows, MODE_CODE[mode], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"direct copy: CUDA error {err}")
    return out


def variants(mode, dev, rows, tma_rows, parent):
    """{name: fn(src) -> out} for ``mode``; ``floor`` writes one buffer."""
    X, Y = rp.X, rp.Y
    xi, yi = hw.window_indices(X, Y, mode, **GEOM, device=dev)
    floor_out = torch.empty((1, X, Y, rp.Z), dtype=torch.float32, device=dev)
    out = {"kernel": lambda s: hw.window_copy(s, mode, **GEOM)}
    if parent is not None:
        out["parent"] = lambda s: parent.window_copy(s, mode, **GEOM)
    stream = torch.cuda.current_stream().cuda_stream
    for r in tma_rows:
        if hw.plan(rp.Z, rp.R, rp.Ry, mode, r)[3] <= hw._SMEM_MAX:
            out[f"tma_rows{r}"] = lambda s, r=r: hw._launch(hw._library(), stream, s, mode,
                                                            **GEOM, rows=r)
    for r in rows:
        out[f"direct_rows{r}"] = lambda s, r=r: direct(s, mode, r)
    out["plain"] = lambda s: hw.window_copy_reference(s, mode, **GEOM)
    out["gather"] = lambda s: s[0][xi[:, None], yi[None, :]]
    out["floor"] = lambda s: floor_out[0].copy_(s[0])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None, help="a parent tree's ops and csrc")
    p.add_argument("--rows", default="1,2,4,8", help="x rows per block of the direct copy")
    p.add_argument("--tma-rows", default="1,2,4,8", help="x rows per block of the TMA variants")
    p.add_argument("--reps", type=int, default=20, help="calls per timed run")
    p.add_argument("--repeats", type=int, default=7, help="timed runs (the median is kept)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_window_copy: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    parent = cs.load_parent("hopper_window_copy", a.parent) if a.parent else None
    rows = [int(r) for r in a.rows.split(",") if r]
    tma_rows = [int(r) for r in a.tma_rows.split(",") if r]
    shape = (rp.N, rp.X, rp.Y, rp.Z)
    rng = np.random.default_rng(5)
    warm = (torch.arange(np.prod(shape), dtype=torch.float32, device=dev).reshape(shape)
            / 1e6)
    colds = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
             for _ in range(32)]
    kind = "PCIe" if "PCIe" in torch.cuda.get_device_name(0) else "SXM"
    bound = 2 * rp.X * rp.Y * rp.Z * 4 / cs.HBM_PEAK[kind] * 1e3
    for mode in hw.MODES:
        fns = variants(mode, dev, rows, tma_rows, parent)
        ref = hw.window_copy_reference(warm, mode, **GEOM)
        for name, fn in fns.items():
            got = fn(warm)
            want = warm[0] if name == "floor" else ref
            torch.cuda.synchronize()
            cs.check(torch.equal(got.reshape(want.shape), want),
                     f"{name} {mode}: differs from the plain version")
        res = {name: {"warm": [], "cold": []} for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                fn = fns[name]
                cyc = itertools.cycle(colds)
                for key, run in (("warm", lambda: fn(warm)), ("cold", lambda: fn(next(cyc)))):
                    res[name][key].append(cs.device_time_ms(run, a.reps, a.repeats))
                    print(json.dumps({"probe_run": name, "mode": mode, "input": key,
                                      **res[name][key][-1]}), flush=True)
        for name, r in res.items():
            print(json.dumps({
                "probe": "window_copy", "mode": mode, "variant": name,
                "ms": [t["ms"] for t in r["warm"]],
                "wall_ms": [t["wall_ms"] for t in r["warm"]],
                "wall_min_ms": [t["wall_min_ms"] for t in r["warm"]],
                "cold_ms": [t["ms"] for t in r["cold"]],
                "cold_wall_ms": [t["wall_ms"] for t in r["cold"]],
                "queued": all(t["queued"] for t in r["warm"] + r["cold"]),
                "bound_ms": bound, "bound_share": bound / min(t["ms"] for t in r["warm"]),
                "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
