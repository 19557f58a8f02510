"""PyTorch port, the kernel-family bench harness (``utils/bench_kernels.py``)
against the JAX package's, in float64 on the CPU:

- every family of ``FAMILIES`` (JAX's 21 names, in JAX's order) has smoke
  keyword arguments here, builds, steps twice with finite outputs and
  positive bytes, and leaves its carry, consts and closure bit-unchanged;
  ``vep2d_1024`` and the three 254³ families are held as the n-family called
  at n = 1024 or 254, built here at a small n in its place;
- each factory keeps JAX's signature, plus ``device``;
- each family at a small size against JAX's family with the same keyword
  arguments: carry and consts bit-equal, the same ``bytes_per_iter`` and
  ``n_cells``, ``step(2)`` within 1e-12 of each field's max (the 3D VEP
  families within tests/test_pallas_vep3d_blocked.py's ``_ATOL``). Two
  const sets are held as the parity tests of the functions that make them
  hold them: the 3D VE canvas coefficients within rtol 1e-12, atol 1e-14
  (tests/test_torch_stokes3d.py; ``b_e`` differs by an ulp), and the 3D
  VEP hoisted τ_o interpolants on the slots their family owns
  (tests/test_torch_stokes3d_vep.py; JAX's "slice" shift zero-fills wrapped
  slots that the port's roll fills, and neither is read). JAX's Pallas
  families run in interpret mode where that takes a few seconds
  (``pallas_ve2d``, ``pallas_vep2d``, ``pallas_thermal2d``); the others are
  held to JAX's family with the same set-up on the other route
  (``pallas_ve2d`` for ``pallas_ve2d_blocked``, ``pallas_vep2d`` for
  ``pallas_vep2d_blocked``, ``ve3d_canvas`` for ``pallas_ve3d_blocked``,
  ``vep3d_canvas`` for the three ``pallas_vep3d_*``), their consts to JAX's
  own factory;
- ``stream_bytes_per_iter`` of the plain families equals JAX's, but for the
  nine material rows that JAX's trace of ``vep2d`` and ``vep3d`` never reads
  (the density and thermal properties), and keeps JAX's properties
  (tests/test_bench_kernels.py);
- every TPU blocking or lowering argument away from its JAX default raises
  ``ValueError``; ``build_family_on_cpu`` moves every tensor once.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.utils import bench_kernels as jb
from justrelax_tpu_torch.ops.stokes3d_vep_canvas import edge_masks
from justrelax_tpu_torch.utils import bench_kernels as pb

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
# tests/test_pallas_vep3d_blocked.py:108
_ATOL = {False: 1e-14, True: 1e-9}

# per-family small sizes (JAX's tests/test_bench_families_smoke.py table,
# smaller where the card's kernels need no blocking constraint)
SMOKE_KWARGS = {
    "ve2d": dict(nx=32, ny=32),
    "vep2d": dict(n=24),
    "vep2d_1024": dict(),
    "thermal2d": dict(nx=30, ny=30),
    "thermal3d": dict(n=12),
    "ve3d": dict(n=12),
    "ve3d_canvas": dict(n=12),
    "vep3d": dict(n=10),
    "vep3d_canvas": dict(n=10),
    "ve3d_254": dict(),
    "ve3d_canvas_254": dict(),
    "pallas_ve3d_blocked_254": dict(),
    "pallas_ve2d": dict(n=62),
    "pallas_vep3d_blocked": dict(n=10),
    "pallas_vep3d_edges": dict(n=10),
    "pallas_vep3d_split": dict(n=10),
    "pallas_ve2d_blocked": dict(n=62),
    "pallas_ve3d_blocked": dict(n=12),
    "pallas_vep2d": dict(n=62),
    "pallas_vep2d_blocked": dict(n=62),
    "pallas_thermal2d": dict(n=62),
}

# fixed-size families: (the n-family they call, the n they ask for, the
# size built here in its place)
FIXED = {
    "vep2d_1024": ("vep2d", 1024, 16),
    "ve3d_254": ("ve3d", 254, 8),
    "ve3d_canvas_254": ("ve3d_canvas", 254, 8),
    "pallas_ve3d_blocked_254": ("pallas_ve3d_blocked", 254, 8),
}

# port family: (JAX family held against, its keyword arguments); where the
# two names differ, the consts are held to JAX's own factory
PARITY = {
    "ve2d": ("ve2d", dict(nx=32, ny=32)),
    "vep2d": ("vep2d", dict(n=24)),
    "thermal2d": ("thermal2d", dict(nx=30, ny=30)),
    "thermal3d": ("thermal3d", dict(n=12)),
    "ve3d": ("ve3d", dict(n=12)),
    "vep3d": ("vep3d", dict(n=10)),
    "ve3d_canvas": ("ve3d_canvas", dict(n=12)),
    "vep3d_canvas": ("vep3d_canvas", dict(n=10)),
    "pallas_ve2d": ("pallas_ve2d", dict(n=62)),
    "pallas_ve2d_blocked": ("pallas_ve2d", dict(n=62)),
    "pallas_vep2d": ("pallas_vep2d", dict(n=62)),
    "pallas_vep2d_blocked": ("pallas_vep2d", dict(n=62)),
    "pallas_thermal2d": ("pallas_thermal2d", dict(n=62)),
    "pallas_ve3d_blocked": ("ve3d_canvas", dict(n=12)),
    "pallas_vep3d_blocked": ("vep3d_canvas", dict(n=10)),
    "pallas_vep3d_edges": ("vep3d_canvas", dict(n=10)),
    "pallas_vep3d_split": ("vep3d_canvas", dict(n=10)),
}
PLAIN = ("ve2d", "vep2d", "thermal2d", "thermal3d", "ve3d", "vep3d", "ve3d_canvas",
         "vep3d_canvas")   # the plain families of PARITY
PLAIN_FIXED = ("vep2d_1024", "ve3d_254", "ve3d_canvas_254")
# the material rows JAX's traces of vep2d and vep3d do not read (its
# stream counts none of them; the port's closure holds the whole table)
UNREAD_MATERIAL = ("rho0", "alpha", "beta", "T0", "P0", "Cp", "k", "H_r", "gravity")

# the TPU kernels in interpret mode, as the JAX package's tests run them
_INTERPRET = (("justrelax_tpu.ops.pallas_stokes", "stokes_chunk_vmem"),
              ("justrelax_tpu.ops.pallas_stokes_vep", "stokes_vep_chunk_vmem"),
              ("justrelax_tpu.ops.pallas_thermal", "thermal_chunk_vmem"))


def _interpret():
    import importlib

    saved = []
    for mod, name in _INTERPRET:
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, functools.partial(getattr(m, name), interpret=True))
    return saved


@functools.lru_cache(maxsize=None)
def _jax_family(name, items, run=True):
    """JAX's family ``name`` in float64 (``items``: its keyword arguments),
    its Pallas kernels in interpret mode: (carry, consts, bytes, n_cells,
    step(2) leaves or None)."""
    saved = _interpret()
    try:
        step, carry, consts, bpi, n_cells = jb.FAMILIES[name](dtype=jnp.float64, **dict(items))
        out = None
        if run:
            out = [np.asarray(x) for x in jax.tree.leaves(
                step(jnp.asarray(2, jnp.int32), carry, consts))]
    finally:
        for m, fn_name, fn in saved:
            setattr(m, fn_name, fn)
    return carry, consts, bpi, n_cells, out


def _arrays(tree):
    """JAX leaves that are arrays, as numpy (a coefficient that is a number
    is compared apart)."""
    return [np.asarray(x) for x in jax.tree.leaves(tree) if hasattr(x, "shape")]


def _numbers(tree):
    return [float(x) for x in jax.tree.leaves(tree) if not hasattr(x, "shape")]


def _port_numbers(tree):
    if isinstance(tree, torch.Tensor) or tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _port_numbers(v)]
    if isinstance(tree, float):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _port_numbers(getattr(tree, f.name))]
    return []


def _rel(a, b):
    d = np.max(np.abs(a - b), initial=0.0)
    return 0.0 if d == 0.0 else d / np.max(np.abs(b), initial=0.0)


def _build(name, monkeypatch):
    """The port's family ``name`` at its smoke size on the CPU in float64; a
    fixed-size family through its n-family at the small size of FIXED,
    after checking that it asks for its own n."""
    if name in FIXED:
        base, n_asked, n_small = FIXED[name]
        orig = getattr(pb, base)
        asked = []

        def small(n, **kw):
            asked.append(n)
            return orig(n=n_small, **kw)

        monkeypatch.setattr(pb, base, small)
        out = pb.FAMILIES[name](**F64)
        assert asked == [n_asked]
        return out
    return pb.FAMILIES[name](**SMOKE_KWARGS[name], **F64)


def test_every_family_registered_has_smoke_kwargs():
    assert set(SMOKE_KWARGS) == set(pb.FAMILIES)
    assert list(pb.FAMILIES) == list(jb.FAMILIES)


@pytest.mark.parametrize("name", list(jb.FAMILIES))
def test_signature_is_jax(name):
    """JAX's parameters, names and defaults, in order, then ``device=None``
    (``dtype``'s default the torch dtype of JAX's)."""
    want = inspect.signature(jb.FAMILIES[name]).parameters
    got = inspect.signature(pb.FAMILIES[name]).parameters
    if list(want) == ["kw"]:
        assert list(got) == ["kw"]
        return
    assert list(got) == list(want) + ["device"]
    assert got["device"].default is None
    for p in want.values():
        if p.name == "dtype":
            assert got["dtype"].default is torch.float32 and p.default is jnp.float32
        else:
            assert got[p.name].default == p.default, p.name


@pytest.mark.parametrize("name", list(pb.FAMILIES))
def test_family_builds_and_steps(name, monkeypatch):
    """Builds, steps twice with finite outputs, positive bytes, and leaves
    its carry, consts and closure bit-unchanged."""
    step, carry, consts, bpi, n_cells = _build(name, monkeypatch)
    assert bpi > 0 and n_cells > 0
    assert (step.kernel is None) == (name in PLAIN + PLAIN_FIXED)
    inputs = pb._leaves((carry, consts, step.closure))
    before = [t.clone() for t in inputs]
    out = pb._leaves(step(2, carry, consts))
    assert out
    for t in out:
        assert bool(torch.isfinite(t).all())
    for a, b in zip(inputs, before):
        assert torch.equal(a, b)
    # on the CPU the kernel's wrapper runs its plain version
    ref = pb._leaves(step.reference(2, carry, consts))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("name", sorted(PARITY))
def test_family_matches_jax(name):
    jname, kw = PARITY[name]
    items = tuple(sorted(kw.items()))
    step, carry, consts, bpi, n_cells = pb.FAMILIES[name](**kw, **F64)
    jcarry, jconsts, jbpi, jn, jout = _jax_family(jname, items)
    if name != jname:   # the other route: JAX's own factory for the consts
        jcarry, jconsts, jbpi, jn, _ = _jax_family(name, items, run=False)
    assert (bpi, n_cells) == (jbpi, jn)

    got, want = pb._leaves(carry), _arrays(jcarry)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)

    got, want = pb._leaves(consts), _arrays(jconsts)
    assert len(got) == len(want)
    assert _port_numbers(consts) == _numbers(jconsts)
    if name in ("ve3d_canvas", "pallas_ve3d_blocked"):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-14)
    elif "vep3d_" in name:
        hoisted = consts.params.tau_o6_e
        assert (hoisted is None) == (jconsts.params.tau_o6_e is None)
        skip = {id(t) for fam in (hoisted or ()) for t in fam}
        for a, b in zip(got, want):
            if id(a) not in skip:
                np.testing.assert_array_equal(a.numpy(), b)
        _, Me = edge_masks(tuple(consts.P0.shape))
        for k in range(3 if hoisted is not None else 0):
            m = Me[k].expand(consts.P0.shape).numpy()
            for a, b in zip(hoisted[k], jconsts.params.tau_o6_e[k]):
                np.testing.assert_array_equal(a.numpy()[m], np.asarray(b)[m])
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)

    out = pb._leaves(step(2, carry, consts))
    assert len(out) == len(jout)
    if "vep3d" in name:
        # the carry ends with λ and λ_e×3: plastic where any is > 0
        tol = _ATOL[any(float(b.max()) > 0 for b in jout[-4:])]
        for a, b in zip(out, jout):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)
    else:
        for a, b in zip(out, jout):
            assert _rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("name", PLAIN)
def test_stream_bytes_match_jax(name):
    kw = PARITY[name][1]
    got = pb.stream_bytes_per_iter(name, dict(kw, **F64))
    want = jb.stream_bytes_per_iter(name, dict(kw, dtype=jnp.float64))
    unread = 0
    if name in ("vep2d", "vep3d"):
        step = pb.FAMILIES[name](**kw, **F64)[0]
        material = step.closure["material"].params
        unread = sum(getattr(material, f).numel() * 8 for f in UNREAD_MATERIAL)
    assert got - unread == want


def test_stream_bytes_accounting():
    """tests/test_bench_kernels.py's properties: the stream is at least
    twice the carry, within 4× the necessary traffic, and ~quadratic in n."""
    for fam, kw in (("vep2d", {"n": 24}), ("ve2d", {"nx": 32, "ny": 32})):
        _, carry, _, bpi, _ = pb.FAMILIES[fam](**kw, **F64)
        sb = pb.stream_bytes_per_iter(fam, dict(kw, **F64))
        assert sb >= 2 * pb._array_bytes(carry)
        assert sb <= 4 * bpi
    s24 = pb.stream_bytes_per_iter("vep2d", dict(n=24, **F64))
    s48 = pb.stream_bytes_per_iter("vep2d", dict(n=48, **F64))
    assert 3.0 < s48 / s24 < 5.0


@pytest.mark.parametrize("name,arg,value", [
    ("pallas_vep2d_blocked", "row_block", 64),
    ("pallas_vep2d_blocked", "iters_per_pass", 4),
    ("ve3d_canvas", "lean", True),
    ("ve3d_canvas", "shift", "roll"),
    ("pallas_ve3d_blocked", "plane_block", 8),
    ("pallas_ve3d_blocked", "iters_per_pass", 2),
    ("pallas_ve3d_blocked", "pipeline", True),
    ("pallas_ve3d_blocked", "y_block", 8),
    ("vep3d_canvas", "plane_block", 8),
    ("vep3d_canvas", "iters_per_pass", 2),
    ("vep3d_canvas", "y_block", 8),
    ("vep3d_canvas", "nvals", 4),
    ("vep3d_canvas", "edges_nvals", 4),
    ("pallas_vep3d_blocked", "nvals", 4),
    ("pallas_vep3d_edges", "edges_nvals", 4),
    ("pallas_vep3d_split", "edges_nvals", 4),
])
def test_tpu_only_arguments_raise(name, arg, value):
    with pytest.raises(ValueError, match=f"{arg}=.*TPU blocking or lowering"):
        pb.FAMILIES[name](n=8, **{arg: value}, **F64)


@pytest.mark.parametrize("name", ["ve3d", "pallas_vep2d", "pallas_vep3d_split"])
def test_build_family_on_cpu_moves_each_tensor_once(name):
    """Built on the CPU, moved to the meta device: every tensor of carry,
    consts, closure and set-up there, each tensor the family holds in
    several places still one tensor; on the CPU it is the family itself."""
    kw = dict(SMOKE_KWARGS[name], dtype=torch.float64)
    step, carry, consts, bpi, n_cells = pb.build_family_on_cpu(name, kw, device="meta")
    _, carry0, consts0, bpi0, n0 = pb.FAMILIES[name](**kw, device="cpu")
    assert (bpi, n_cells) == (bpi0, n0)
    moved = pb._leaves((carry, consts, step.closure, step.setup))
    assert moved and all(t.device.type == "meta" for t in moved)
    src = pb._leaves((carry0, consts0))
    dst = pb._leaves((carry, consts))
    for i, a in enumerate(src):
        for j in range(i + 1, len(src)):
            assert (src[j] is a) == (dst[j] is dst[i])
    step, carry, consts, _, _ = pb.build_family_on_cpu(name, kw, device="cpu")
    for a, b in zip(pb._leaves((carry, consts)), src):
        assert torch.equal(a, b)
