"""PyTorch port: kernels 1-4 held bit for bit to the counting template.

Imports no JAX, so the card tests run on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_sweep_bits.py

(`--noconftest`: `tests/conftest.py` imports JAX). On the small
Krusell-Smith grid (40×5, the rouwenhorst income process of
`tests/conftest.py::build_small_ks`, T = 12) with seeded inputs shaped as
the EGM meets them (marginal values of a consumption rule rising in wealth),
each new kernel of `hank_tpu_torch/csrc/household_sweep.cu` is held to the
previous kernel (`household_sweep_kernel`, the `_previous` wrappers) on
every output bit, NaNs included: kernel 2, kernels 3-4 and the batched
kernel 2, near the steady state and on the grid with two knots swapped
(the fallback branches, whose counts are checked per path); kernel 1 too;
and the rows of a batched launch equal single launches of kernel 1 and of
kernel 2. Here, without a card, those tests skip; the CPU test checks that
`ops/cuda_build._SIGNATURES` declares every entry point of the sources.
"""

import re

import numpy as np
import pytest
import torch

from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
from hank_tpu_torch.models import load_model
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops.fused_residual import (fused_residual_sweep,
                                               fused_residual_sweep_batch,
                                               fused_residual_sweep_batch_previous,
                                               fused_residual_sweep_previous)
from hank_tpu_torch.ops.fused_sweep import fused_sweep_jvp
from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                  fused_sweep_jvp_batch_previous)

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64


def exported_entry_points(source: str) -> dict:
    """{name: (pointers, ints, doubles) before the trailing stream} of each
    `int hank_*(...)` launcher in a kernel source's extern "C" block, outside
    `#ifdef` blocks (probes built only with a macro), with the `*_ENTRY_PARAM`
    macros empty, as the library is built."""
    text = open(source).read()
    text = text[text.index('extern "C" {'):]
    text = re.sub(r"#ifdef.*?#endif", "", text, flags=re.S)
    text = re.sub(r"\bK\d_ENTRY_PARAM\b", "", text)
    out = {}
    for name, params in re.findall(r"^int (hank_\w+)\(([^)]*)\)", text, flags=re.M):
        kinds = [p.strip().rsplit(" ", 1)[0].replace("const ", "") for p in params.split(",")]
        if kinds[-1] != "void*" or "stream" not in params.split(",")[-1]:
            continue                                     # not a kernel launcher
        kinds = kinds[:-1]
        out[name] = (kinds.count("void*"), kinds.count("int"), kinds.count("double"))
        assert kinds == (["void*"] * out[name][0] + ["int"] * out[name][1]
                         + ["double"] * out[name][2]), f"{name}: pointers, ints, doubles"
    return out


@pytest.mark.parametrize("library", cuda_build.LIBRARIES)
def test_signatures_name_every_exported_entry_point(library):
    """`cuda_build._SIGNATURES` declares every launcher of the source with
    its argument counts, and nothing else: ctypes would otherwise pass a
    pointer as a 32-bit int or shift the arguments."""
    assert exported_entry_points(cuda_build.SOURCES[library]) == \
        cuda_build._SIGNATURES[library]


def test_sass_listing_is_compared_per_kernel():
    """`tools/sass_compare`: instructions without addresses, encodings or
    padding; the anonymous namespace's file-specific part and the file-wide
    branch label numbers dropped, so a copy of a source under another name
    compares equal kernel by kernel, and a changed instruction shows."""
    from hank_tpu_torch.tools.sass_compare import compare, parse_sass

    def listing(anon, first_label, op):
        return (f"\t\tFunction : _ZN51_GLOBAL__N__8ce16936_18_{anon}_cu_42b7fca822kern\n"
                "        /*0000*/                   MOV R1, c[0x0][0x28] ;"
                "                  /* 0x00000a0000017a02 */\n"
                "                                                        /* 0x000e2200 */\n"
                f"        /*0010*/              @P0 BRA `(.L_x_{first_label}) ;  /* 0x0 */\n"
                f"        /*0020*/                   {op} R2, R3, R4 ;  /* 0x0 */\n")

    old = parse_sass(listing("household_sweep", 7, "FADD"))
    new = parse_sass(listing("pr_copy", 12, "FADD"))
    assert old == new == {"_ZN_anon_22kern": ["MOV R1, c[0x0][0x28]", "@P0 BRA `(.L0)",
                                              "FADD R2, R3, R4"]}
    changed = parse_sass(listing("household_sweep", 7, "FFMA"))["_ZN_anon_22kern"]
    assert compare(old["_ZN_anon_22kern"], changed) == {
        "old_instructions": 3, "new_instructions": 3, "identical": False,
        "first_difference": 2, "old_text": "FADD R2, R3, R4", "new_text": "FFMA R2, R3, R4"}


def test_sweep_ab_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hank_tpu_torch.tools import sweep_ab

    assert sweep_ab.main([]) == 1


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def kernel_kwargs():
    p = load_model("krusell_smith", T=12, device="cpu").params
    return dict(beta=p["β"], gamma=p["γ"], borrow_cons=p["borrow_cons"])


def inputs(B, dtype, device, seed=0, n_a=40, n_e=5, Tm1=11):
    """(r, w, dr, dw) price paths and tangents, (B, T-1) each, near a KS
    steady state, and the shared (V_T, D0, grid, e_grid, Pi)."""
    rng = np.random.default_rng(seed)
    grid = make_double_exponential_grid(0.0, 200.0, n_a)
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    r0, w0 = 0.01, 0.9
    c = 0.05 * grid[:, None] + 0.9 * w0 * z[None, :] + 0.3
    V = (1 + r0) * c ** -2.0                              # (n_a, n_e)
    D = rng.uniform(0.5, 1.5, (n_a, n_e))
    paths = (r0 * (1 + 0.05 * rng.normal(size=(B, Tm1))), w0 * (1 + 0.02 * rng.normal(size=(B, Tm1))),
             0.01 * rng.normal(size=(B, Tm1)), 0.01 * rng.normal(size=(B, Tm1)))

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return [t(a) for a in paths], [t(a) for a in (V, D / D.sum(), grid, z, Pi)]


def swapped_grid(c, k=5):
    """The shared inputs with the grid's knots k and k + 1 swapped."""
    grid = c[2].clone()
    grid[[k, k + 1]] = grid[[k + 1, k]]
    return [*c[:2], grid, *c[3:]]


def same_bits(a, b) -> bool:
    """Equal shapes and bit patterns (NaNs included)."""
    view = torch.int64 if a.dtype == f64 else torch.int32
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


@pytest.mark.gpu
def test_kernel2_on_card_is_bit_for_bit_the_template(cuda):
    """Kernel 2 against the previous kernel 2 on both outputs, near the
    steady state and on the swapped grid (its fallback branches); wrong
    fallback_rows refused."""
    kw = kernel_kwargs()
    paths, c = inputs(1, f64, cuda, seed=1)
    r, w = paths[0][0], paths[1][0]
    counts = []
    for shared in (c, swapped_grid(c)):
        fallback = torch.zeros(2, dtype=torch.int32, device=cuda)
        launches = (fused_residual_sweep.launches, fused_residual_sweep_previous.launches)
        out = fused_residual_sweep(r, w, *shared, **kw, fallback_rows=fallback)
        old = fused_residual_sweep_previous(r, w, *shared, **kw)
        assert (fused_residual_sweep.launches, fused_residual_sweep_previous.launches) == \
            (launches[0] + 1, launches[1] + 1)
        assert all(same_bits(o, q) for o, q in zip(out, old))
        counts.append(fallback.tolist())
    assert counts[0] == [0, 0] and sum(counts[1]) > 0
    for bad in (torch.zeros(3, dtype=torch.int32, device=cuda),       # shape
                torch.zeros(2, dtype=torch.int64, device=cuda),       # dtype
                torch.zeros(2, dtype=torch.int32)):                   # device
        with pytest.raises(ValueError, match="fallback_rows"):
            fused_residual_sweep(r, w, *c, **kw, fallback_rows=bad)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [5, 1])
def test_kernels3_4_on_card_are_bit_for_bit_the_template(cuda, B):
    """Kernels 3-4 against the previous kernels 3-4 on every row and
    output, near the steady state and on the swapped grid, where every path
    counts fallback rows; wrong fallback_rows refused."""
    kw = kernel_kwargs()
    paths, c = inputs(B, f32, cuda, seed=2)
    counts = []
    for shared in (c, swapped_grid(c)):
        fallback = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        launches = (fused_sweep_jvp_batch.launches, fused_sweep_jvp_batch_previous.launches)
        out = fused_sweep_jvp_batch(*paths, *shared, **kw, fallback_rows=fallback)
        old = fused_sweep_jvp_batch_previous(*paths, *shared, **kw)
        assert (fused_sweep_jvp_batch.launches, fused_sweep_jvp_batch_previous.launches) == \
            (launches[0] + 1, launches[1] + 1)
        assert all(same_bits(o, q) for o, q in zip(out, old))
        counts.append(fallback)
    assert int(counts[0].sum()) == 0 and bool((counts[1].sum(1) > 0).all())
    for bad in (torch.zeros(2 * B, dtype=torch.int32, device=cuda),         # shape
                torch.zeros((B, 2), dtype=torch.float32, device=cuda),      # dtype
                torch.zeros((B, 2), dtype=torch.int32)):                    # device
        with pytest.raises(ValueError, match="fallback_rows"):
            fused_sweep_jvp_batch(*paths, *c, **kw, fallback_rows=bad)


@pytest.mark.gpu
def test_batched_kernel2_on_card_is_bit_for_bit_the_template(cuda):
    """The batched kernel 2 against the previous batched kernel 2 on every
    row, near the steady state, on the swapped grid and with a NaN price on
    path 1: only that path counts implied-wealth fallback rows there."""
    kw = kernel_kwargs()
    paths, c = inputs(3, f64, cuda, seed=3)
    r, w = paths[:2]
    r_nan = r.clone()
    r_nan[1, 5] = float("nan")
    for rr, shared in ((r, c), (r, swapped_grid(c)), (r_nan, c)):
        fallback = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
        out = fused_residual_sweep_batch(rr, w, *shared, **kw, fallback_rows=fallback)
        old = fused_residual_sweep_batch_previous(rr, w, *shared, **kw)
        assert all(same_bits(o, q) for o, q in zip(out, old))
    assert int(fallback[1, 0]) > 0 and fallback[[0, 2], 0].tolist() == [0, 0]


@pytest.mark.gpu
def test_kernel1_on_card_is_bit_for_bit_the_template(cuda):
    """Kernel 1 against the counting template's B = 1 launch, near the
    steady state and on the swapped grid."""
    kw = kernel_kwargs()
    paths, c = inputs(1, f32, cuda, seed=4)
    for shared in (c, swapped_grid(c)):
        out = fused_sweep_jvp(*(p[0] for p in paths), *shared, **kw)
        old = fused_sweep_jvp_batch_previous(*paths, *shared, **kw)
        assert all(same_bits(o, q[0]) for o, q in zip(out, old))


@pytest.mark.gpu
def test_batched_rows_on_card_equal_single_launches(cuda):
    """Row b of kernels 3-4 is a launch of kernel 1 on row b, and row b of
    the batched kernel 2 a launch of kernel 2, bit for bit."""
    kw = kernel_kwargs()
    paths, c = inputs(4, f32, cuda, seed=5)
    out = fused_sweep_jvp_batch(*paths, *c, **kw)
    paths64, c64 = inputs(4, f64, cuda, seed=5)
    out64 = fused_residual_sweep_batch(*paths64[:2], *c64, **kw)
    for b in range(4):
        single = fused_sweep_jvp(*(p[b] for p in paths), *c, **kw)
        assert all(same_bits(o[b], q) for o, q in zip(out, single))
        single64 = fused_residual_sweep(paths64[0][b], paths64[1][b], *c64, **kw)
        assert all(same_bits(o[b], q) for o, q in zip(out64, single64))
