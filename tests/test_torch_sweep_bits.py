"""PyTorch port: kernels 1-4 and the f64 tangent sweep held bit for bit to
the counting template, and kernel 7 to the previous kernel 7.

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
(the fallback branches, whose counts are checked per path); kernel 1 and
the f64 tangent sweep (`fused_sweep_jvp_f64`, against
`fused_sweep_jvp_f64_previous`) too; and the rows of a batched launch equal
single launches of kernel 1 and of kernel 2. The five cluster
instantiations (`csrc/household_sweep_cluster.cu`: in kernel 1's, the f64
tangent sweep's, kernel 2's places, and the batched kernel 2's and kernels
3-4's) are held to the global-state instantiations and the one-block
kernels at 40×5, 40×9 and 40×17 (clusters of 5 and 8 blocks, one to three
rows a block) and to the global-state ones at 1200×7; the batched ones at
every cluster size, each row bit for bit a single-path cluster launch.
Kernel 7 (`forward_scan`) is
held to the previous kernel 7 (`forward_scan_previous`) on seeded monotone
policies, with 10% noise (fallback rows), one NaN policy and every policy
clamped at a grid end. Here, without a card, those tests skip; the CPU test
checks that `ops/cuda_build._SIGNATURES` declares every entry point of the
sources.
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
                                               fused_residual_sweep_batch_cluster,
                                               fused_residual_sweep_batch_global,
                                               fused_residual_sweep_batch_previous,
                                               fused_residual_sweep_cluster,
                                               fused_residual_sweep_global,
                                               fused_residual_sweep_previous,
                                               fused_residual_sweep_reference)
from hank_tpu_torch.ops.forward_scan import (forward_scan, forward_scan_previous,
                                             forward_scan_reference)
from hank_tpu_torch.ops.fused_sweep import (fused_sweep_jvp, fused_sweep_jvp_cluster,
                                            fused_sweep_jvp_f64, fused_sweep_jvp_f64_cluster,
                                            fused_sweep_jvp_f64_global,
                                            fused_sweep_jvp_f64_previous,
                                            fused_sweep_jvp_global, fused_sweep_jvp_reference)
from hank_tpu_torch.ops.fused_sweep_batch import (fused_sweep_jvp_batch,
                                                  fused_sweep_jvp_batch_cluster,
                                                  fused_sweep_jvp_batch_global,
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


def test_sweep_split_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hank_tpu_torch.tools import sweep_split

    assert sweep_split.main([]) == 1


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


@pytest.mark.gpu
def test_f64_tangent_sweep_on_card_is_bit_for_bit_the_template(cuda):
    """`<double, true, false>` against the counting template's launch on all
    four outputs, near the steady state and on the swapped grid (its
    fallback branches); within 1e-10 of its plain version in f64 near the
    steady state; a zero tangent exactly zero."""
    kw = kernel_kwargs()
    paths, c = inputs(1, f64, cuda, seed=6)
    single = [p[0] for p in paths]
    counts = []
    for shared in (c, swapped_grid(c)):
        fallback = torch.zeros(2, dtype=torch.int32, device=cuda)
        launches = (fused_sweep_jvp_f64.launches, fused_sweep_jvp_f64_previous.launches)
        out = fused_sweep_jvp_f64(*single, *shared, **kw, fallback_rows=fallback)
        old = fused_sweep_jvp_f64_previous(*single, *shared, **kw)
        assert (fused_sweep_jvp_f64.launches, fused_sweep_jvp_f64_previous.launches) == \
            (launches[0] + 1, launches[1] + 1)
        assert all(same_bits(o, q) for o, q in zip(out, old))
        counts.append(fallback.tolist())
    assert counts[0] == [0, 0] and sum(counts[1]) > 0
    out = fused_sweep_jvp_f64(*single, *c, **kw)
    ref = fused_sweep_jvp_reference(*(a.cpu() for a in (*single, *c)), **kw)
    for o, q in zip(out, ref):
        assert float((o.cpu() - q).abs().max()) <= 1e-10 * max(float(q.abs().max()), 1.0)
    zero = torch.zeros_like(single[2])
    out0 = fused_sweep_jvp_f64(*single[:2], zero, zero, *c, **kw)
    assert bool((out0[1] == 0).all() and (out0[3] == 0).all())


def with_nan(c):
    """The shared inputs with one NaN in V_T."""
    V = c[0].clone()
    V[17, 2] = float("nan")
    return [V, *c[1:]]


@pytest.mark.gpu
def test_global_state_instantiations_on_card_are_bit_for_bit_the_one_block_kernels(cuda):
    """Each global-state instantiation against the one-block kernel whose
    place it takes, on every output bit and fallback count: near the steady
    state, on the swapped grid and with a NaN in V_T (fallback branches
    taken); `<float, true, false, true>` against kernel 1, every batched row
    against a single global-state launch; `.launches_global` counts them."""
    kw = kernel_kwargs()
    p32, c32 = inputs(3, f32, cuda, seed=9)
    p64, c64 = inputs(3, f64, cuda, seed=9)
    singles = ((fused_sweep_jvp, fused_sweep_jvp_global, [p[0] for p in p32], c32),
               (fused_sweep_jvp_f64, fused_sweep_jvp_f64_global, [p[0] for p in p64], c64),
               (fused_residual_sweep, fused_residual_sweep_global, [p[0] for p in p64[:2]],
                c64))
    batches = ((fused_sweep_jvp_batch, fused_sweep_jvp_batch_global, fused_sweep_jvp_global,
                p32, c32),
               (fused_residual_sweep_batch, fused_residual_sweep_batch_global,
                fused_residual_sweep_global, p64[:2], c64))
    for one_block, glob, paths, c in singles:
        for shared in (c, swapped_grid(c), with_nan(c)):
            fb_one, fb_glob = (torch.zeros(2, dtype=torch.int32, device=cuda) for _ in "ab")
            launches = (one_block.launches, one_block.launches_global)
            out = glob(*paths, *shared, **kw, fallback_rows=fb_glob)
            old = one_block(*paths, *shared, **kw, fallback_rows=fb_one)
            assert (one_block.launches, one_block.launches_global) == \
                (launches[0] + 1, launches[1] + 1)
            assert all(same_bits(o, q) for o, q in zip(out, old)), one_block.__name__
            assert torch.equal(fb_one, fb_glob)
        assert int(fb_glob.sum()) > 0
    for one_block, glob, single, paths, c in batches:
        for shared in (c, swapped_grid(c)):
            fb_one, fb_glob = (torch.zeros((3, 2), dtype=torch.int32, device=cuda)
                               for _ in "ab")
            out = glob(*paths, *shared, **kw, fallback_rows=fb_glob)
            old = one_block(*paths, *shared, **kw, fallback_rows=fb_one)
            assert all(same_bits(o, q) for o, q in zip(out, old)), one_block.__name__
            assert torch.equal(fb_one, fb_glob)
            for b in range(3):
                row = single(*(p[b] for p in paths), *shared, **kw)
                assert all(same_bits(o[b], q) for o, q in zip(out, row))


@pytest.mark.gpu
@pytest.mark.parametrize("n_e", [5, 9, 17])
def test_cluster_instantiations_on_card_are_bit_for_bit_the_global_state_kernels(cuda, n_e):
    """Each single-path cluster instantiation against the global-state
    instantiation and the one-block kernel whose place it takes, on every
    output bit and fallback count: near the steady state, on the swapped
    grid and with a NaN in V_T; `<float, true, false>` against kernel 1,
    `<double, false, false>` against kernel 2. At n_e = 5 a cluster of 5
    blocks, one row each; at 9 and 17 a cluster of 8, some blocks holding
    two or three rows. `.launches_cluster` counts them."""
    kw = kernel_kwargs()
    p32, c32 = inputs(1, f32, cuda, seed=11, n_e=n_e)
    p64, c64 = inputs(1, f64, cuda, seed=11, n_e=n_e)
    cases = ((fused_sweep_jvp, fused_sweep_jvp_cluster, fused_sweep_jvp_global,
              [p[0] for p in p32], c32),
             (fused_sweep_jvp_f64, fused_sweep_jvp_f64_cluster, fused_sweep_jvp_f64_global,
              [p[0] for p in p64], c64),
             (fused_residual_sweep, fused_residual_sweep_cluster, fused_residual_sweep_global,
              [p[0] for p in p64[:2]], c64))
    for one_block, cluster, glob, paths, c in cases:
        taken = 0
        for shared in (c, swapped_grid(c), with_nan(c)):
            fb = [torch.zeros(2, dtype=torch.int32, device=cuda) for _ in range(3)]
            launches = (one_block.launches, one_block.launches_cluster)
            out = cluster(*paths, *shared, **kw, fallback_rows=fb[0])
            assert (one_block.launches, one_block.launches_cluster) == \
                (launches[0], launches[1] + 1)
            for fn, f in ((glob, fb[1]), (one_block, fb[2])):
                old = fn(*paths, *shared, **kw, fallback_rows=f)
                assert all(same_bits(o, q) for o, q in zip(out, old)), fn.__name__
                assert torch.equal(fb[0], f), fn.__name__
            taken += int(fb[0].sum())
        assert taken > 0


def batched_cases(p32, c32, p64, c64):
    """(batched wrapper, its cluster entry point, its global-state one, the
    single-path cluster entry point, paths, shared inputs) of kernels 3-4
    and the batched kernel 2."""
    return ((fused_sweep_jvp_batch, fused_sweep_jvp_batch_cluster, fused_sweep_jvp_batch_global,
             fused_sweep_jvp_cluster, p32, c32),
            (fused_residual_sweep_batch, fused_residual_sweep_batch_cluster,
             fused_residual_sweep_batch_global, fused_residual_sweep_cluster, p64[:2], c64))


@pytest.mark.gpu
@pytest.mark.parametrize("n_e", [5, 9])
def test_batched_cluster_instantiations_on_card_at_every_cluster_size(cuda, n_e):
    """`<float, true, true>` and `<double, false, true>` over B = 3 paths on
    clusters of every size C = 1, ..., min(n_e, 8) (one to n_e rows a
    block): every output bit and fallback count equal to the one-block
    batched kernel's and the global-state one's, near the steady state and
    on the swapped grid, and every row bit for bit a single-path cluster
    launch; a cluster larger than min(n_e, 8) refused at launch."""
    kw = kernel_kwargs()
    p32, c32 = inputs(3, f32, cuda, seed=13, n_e=n_e)
    p64, c64 = inputs(3, f64, cuda, seed=13, n_e=n_e)
    for one_block, cluster, glob, single, paths, c in batched_cases(p32, c32, p64, c64):
        for shared in (c, swapped_grid(c)):
            fb_one, fb_glob = (torch.zeros((3, 2), dtype=torch.int32, device=cuda)
                               for _ in "ab")
            old = one_block(*paths, *shared, **kw, fallback_rows=fb_one)
            assert all(same_bits(o, q) for o, q in
                       zip(glob(*paths, *shared, **kw, fallback_rows=fb_glob), old))
            assert torch.equal(fb_one, fb_glob)
            rows = [single(*(p[b] for p in paths), *shared, **kw) for b in range(3)]
            for size in range(1, min(n_e, 8) + 1):
                fb = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
                launches = one_block.launches_cluster
                out = cluster(*paths, *shared, **kw, fallback_rows=fb, cluster=size)
                assert one_block.launches_cluster == launches + 1
                assert all(same_bits(o, q) for o, q in zip(out, old)), (cluster.__name__, size)
                assert torch.equal(fb, fb_one), (cluster.__name__, size)
                for b in range(3):
                    assert all(same_bits(o[b], q) for o, q in zip(out, rows[b]))
        assert int(fb_one.sum()) > 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            cluster(*paths, *c, **kw, cluster=min(n_e, 8) + 1)


@pytest.mark.gpu
def test_cluster_instantiations_on_card_at_1200x7(cuda):
    """At 1200×7 (one row a block on a cluster of 7) each cluster
    instantiation is bit for bit the global-state one on every output and
    fallback count, and the wrappers launch it there; the batched ones over
    B = 2 paths on clusters of 7 and of 4 (two rows a block), every row bit
    for bit a single-path cluster launch."""
    kw = kernel_kwargs()
    for dtype, wrapper, cluster, glob, n_paths in (
            (f32, fused_sweep_jvp, fused_sweep_jvp_cluster, fused_sweep_jvp_global, 4),
            (f64, fused_sweep_jvp_f64, fused_sweep_jvp_f64_cluster, fused_sweep_jvp_f64_global, 4),
            (f64, fused_residual_sweep, fused_residual_sweep_cluster,
             fused_residual_sweep_global, 2)):
        p, c = inputs(1, dtype, cuda, seed=12, n_a=1200, n_e=7, Tm1=20)
        paths = [q[0] for q in p[:n_paths]]
        for shared in (c, swapped_grid(c, k=600)):
            fb_c, fb_g = (torch.zeros(2, dtype=torch.int32, device=cuda) for _ in "ab")
            out = cluster(*paths, *shared, **kw, fallback_rows=fb_c)
            old = glob(*paths, *shared, **kw, fallback_rows=fb_g)
            assert all(same_bits(o, q) for o, q in zip(out, old)), cluster.__name__
            assert torch.equal(fb_c, fb_g)
        launches = wrapper.launches_cluster
        out = wrapper(*paths, *c, **kw)
        assert wrapper.launches_cluster == launches + 1
        assert all(same_bits(o, q) for o, q in zip(out, glob(*paths, *c, **kw)))
    p32, c32 = inputs(2, f32, cuda, seed=14, n_a=1200, n_e=7, Tm1=12)
    p64, c64 = inputs(2, f64, cuda, seed=14, n_a=1200, n_e=7, Tm1=12)
    for wrapper, cluster, glob, single, paths, c in batched_cases(p32, c32, p64, c64):
        for shared in (c, swapped_grid(c, k=600)):
            fb_c, fb_g = (torch.zeros((2, 2), dtype=torch.int32, device=cuda) for _ in "ab")
            old = glob(*paths, *shared, **kw, fallback_rows=fb_g)
            for size in (7, 4):
                out = cluster(*paths, *shared, **kw, fallback_rows=fb_c, cluster=size)
                assert all(same_bits(o, q) for o, q in zip(out, old)), (cluster.__name__, size)
                assert torch.equal(fb_c, fb_g)
            for b in range(2):
                row = single(*(q[b] for q in paths), *shared, **kw)
                assert all(same_bits(o[b], q) for o, q in zip(out, row))
        launches = wrapper.launches_cluster
        out = wrapper(*paths, *c, **kw)
        assert wrapper.launches_cluster == launches + 1
        assert all(same_bits(o, q) for o, q in zip(out, glob(*paths, *c, **kw)))


@pytest.mark.gpu
def test_wrappers_on_card_launch_the_global_state_kernels_past_one_block(cuda):
    """At 1200×7, past every one-block kernel's shared memory, each wrapper
    launches its cluster instantiation by the grid (every one-asset kernel
    has one, and 1200×7 is inside each one's count), within phase 4's
    bounds of its plain version in f64, a zero tangent exactly zero; no
    global-state launch."""
    kw = kernel_kwargs()
    p64, c64 = inputs(2, f64, cuda, seed=10, n_a=1200, n_e=7, Tm1=6)
    p32, c32 = inputs(2, f32, cuda, seed=10, n_a=1200, n_e=7, Tm1=6)
    cpu64 = [a.cpu() for a in c64]

    def close(out, ref, tol):
        for o, q in zip(out, ref):
            assert float((o.double().cpu() - q).abs().max()) <= \
                tol * max(float(q.abs().max()), 1.0)

    before = {fn: (fn.launches, fn.launches_global, getattr(fn, "launches_cluster", 0)) for fn in
              (fused_sweep_jvp, fused_sweep_jvp_f64, fused_residual_sweep,
               fused_sweep_jvp_batch, fused_residual_sweep_batch)}
    ref = fused_sweep_jvp_reference(*(p[0].cpu() for p in p64), *cpu64, **kw)
    ref32 = fused_sweep_jvp_reference(*(p[0].double().cpu() for p in p32),
                                      *(a.double().cpu() for a in c32), **kw)
    close(fused_sweep_jvp_f64(*(p[0] for p in p64), *c64, **kw), ref, 1e-10)
    close(fused_sweep_jvp(*(p[0] for p in p32), *c32, **kw), ref32, 3e-5)
    out_b = fused_sweep_jvp_batch(*p32, *c32, **kw)
    close([o[0] for o in out_b], ref32, 3e-5)
    close(fused_residual_sweep(p64[0][0], p64[1][0], *c64, **kw),
          fused_residual_sweep_reference(p64[0][0].cpu(), p64[1][0].cpu(), *cpu64, **kw),
          1e-11)
    out_b64 = fused_residual_sweep_batch(*p64[:2], *c64, **kw)
    close([o[1] for o in out_b64],
          fused_residual_sweep_reference(p64[0][1].cpu(), p64[1][1].cpu(), *cpu64, **kw),
          1e-11)
    zero = torch.zeros_like(p64[2][0])
    out0 = fused_sweep_jvp_f64(p64[0][0], p64[1][0], zero, zero, *c64, **kw)
    assert bool((out0[1] == 0).all() and (out0[3] == 0).all())
    for fn, (launches, launches_global, launches_cluster) in before.items():
        moved = fn.launches_cluster > launches_cluster and fn.launches_global == launches_global
        assert fn.launches == launches and moved, fn.__name__


def scan_inputs(device, seed=0, T=9, n_a=40, n_e=5):
    """Kernel 7's inputs on the small grid: savings policies rising in
    wealth (a share of cash on hand, with a constrained bottom), a seeded
    D0, the grid and Pi, f32."""
    rng = np.random.default_rng(seed)
    grid = make_double_exponential_grid(0.0, 200.0, n_a)
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    share = 0.9 + 0.05 * rng.uniform(size=(T, 1, 1))
    pols = share * (1.01 * grid[None, :, None] + 0.9 * z[None, None, :]) - 1.0
    D = rng.uniform(0.5, 1.5, (n_a, n_e))

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=f32, device=device)

    return [t(a) for a in (pols, D / D.sum(), grid, Pi)]


@pytest.mark.gpu
def test_kernel7_on_card_is_bit_for_bit_the_previous_kernel(cuda):
    """Kernel 7 against the previous kernel 7 on both outputs (NaNs
    included): monotone policies (no fallback row), 10% i.i.d. noise
    (fallback rows: 1% keeps this coarse grid's rows in order), one NaN policy (a NaN aggregate in its period only)
    and every policy below the grid or above it; within 5e-5 of the plain
    version in f64 on the monotone input."""
    pols, D0, grid, Pi = scan_inputs(cuda)
    rng = np.random.default_rng(7)
    noisy = pols * torch.tensor(1.0 + 0.1 * rng.normal(size=pols.shape), dtype=f32,
                                device=cuda)
    nan = pols.clone()
    nan[3, 17, 2] = float("nan")
    cases = {"monotone": pols, "noise": noisy.contiguous(), "nan": nan,
             "below": torch.full_like(pols, -5.0), "above": torch.full_like(pols, 1e4)}
    counts = {}
    for label, p in cases.items():
        fallback = torch.zeros(1, dtype=torch.int32, device=cuda)
        launches = (forward_scan.launches, forward_scan_previous.launches)
        out = forward_scan(p, D0, grid, Pi, fallback_rows=fallback)
        old = forward_scan_previous(p, D0, grid, Pi)
        assert (forward_scan.launches, forward_scan_previous.launches) == \
            (launches[0] + 1, launches[1] + 1)
        assert all(same_bits(o, q) for o, q in zip(out, old)), label
        counts[label] = int(fallback[0])
    assert counts["monotone"] == counts["below"] == counts["above"] == 0
    assert counts["noise"] > 0 and counts["nan"] > 0
    agg_nan = forward_scan(nan, D0, grid, Pi)[0]
    assert torch.isnan(agg_nan).tolist() == [t == 3 for t in range(pols.shape[0])]
    agg, D_T = forward_scan(pols, D0, grid, Pi)
    ref_agg, ref_D = forward_scan_reference(*(a.double().cpu() for a in (pols, D0, grid, Pi)))
    assert float((agg.double().cpu() - ref_agg).abs().max()) <= \
        5e-5 * max(float(ref_agg.abs().max()), 1.0)
    assert float((D_T.double().cpu() - ref_D).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_kernel7_on_card_past_the_destinations_kept_in_registers(cuda):
    """A grid of 1100×4 = 4400 states: each thread's destinations past the
    first four (those whose ranges live in registers) take the loop that
    reads its ranges at use; bit for bit the previous kernel 7, monotone
    and noisy."""
    pols, D0, grid, Pi = scan_inputs(cuda, seed=8, T=4, n_a=1100, n_e=4)
    rng = np.random.default_rng(8)
    noisy = pols * torch.tensor(1.0 + 0.1 * rng.normal(size=pols.shape), dtype=f32,
                                device=cuda)
    for p in (pols, noisy.contiguous()):
        out = forward_scan(p, D0, grid, Pi)
        old = forward_scan_previous(p, D0, grid, Pi)
        assert all(same_bits(o, q) for o, q in zip(out, old))


# ── Kernel 6 and the f64 forward push past 2048 asset states ───────────────

def two_asset_on(dev, n_b, n_a, n_e=5, T=12):
    """The shipped two-asset model on `dev` at an n_b×n_a×n_e×2 grid (its
    liquid and illiquid bounds, the income process at n_e states)."""
    import dataclasses

    from hank_tpu_torch.model.structures import HeterogeneityDimension as H

    def t(a):
        return torch.tensor(np.asarray(a), dtype=f64, device=dev)

    model = load_model("hank_two_asset", T=T, device=dev)
    Pi, _, z = rouwenhorst(n_e, 0.966, 0.283)
    het = model.heterogeneity
    return dataclasses.replace(model, heterogeneity={
        "liquid": H("liquid", "endogenous", n_b, t(make_double_exponential_grid(0., 120., n_b)),
                    None, "B"),
        "illiquid": H("illiquid", "endogenous", n_a,
                      t(make_double_exponential_grid(0., 300., n_a)), None, "A"),
        "income": H("income", "exogenous", n_e, t(z), t(Pi), None),
        "access": het["access"]})


def two_asset_policies(model, dtype, seed, B=None, nan=False):
    """Seeded forward-kernel inputs on the model's grids, (B,) T-1 periods:
    policies spread past both ends of each grid, 30% of the liquid ones
    piled on the borrowing limit and 10% of the illiquid ones on knots,
    normal tangents, a normalized D0; with `nan` one NaN liquid policy."""
    het = model.heterogeneity
    rng = np.random.default_rng(seed)
    shape = ((B,) if B else ()) + (model.compspec.T - 1, het["liquid"].n, het["illiquid"].n,
                                   het["income"].n, 2)
    bg, ag = het["liquid"].grid.cpu().numpy(), het["illiquid"].grid.cpu().numpy()
    pB = rng.uniform(bg[0] - 1.0, bg[-1] * 1.05, shape)
    pB[rng.random(shape) < 0.3] = bg[0]
    pA = rng.uniform(ag[0] - 1.0, ag[-1] * 1.02, shape)
    on = rng.random(shape) < 0.1
    pA[on] = ag[rng.integers(0, len(ag), int(on.sum()))]
    if nan:
        pB.reshape(-1)[pB.size // 3] = np.nan
    pol = {"B": pB, "A": pA, "C": rng.uniform(0.1, 1.1, shape)}
    D0 = rng.random(shape[-4:])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=het["liquid"].grid.device)

    return ({k: t(v) for k, v in pol.items()},
            {k: t(rng.normal(size=shape)) for k in pol}, t(D0 / D0.sum()))


def outputs_same_bits(a, b) -> bool:
    return all(same_bits(x[k], y[k]) for x, y in zip(a, b) for k in x)


def rows_of(out, b):
    return tuple({k: v[b] for k, v in d.items()} for d in out)


def k6_global(pol, dpol, D0, m32, cluster=None, batch=False):
    """Kernel 6's global-list instantiation (`which` 4) through the
    wrappers' launchers, on `cluster` blocks (default: the wrapper's)."""
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    n_e = m32.heterogeneity["income"].n
    if not batch:
        tensors, Tm1 = fs2._forward_inputs("k6", pol, dpol, D0, m32)
        return fs2._launch_cluster(tensors, Tm1, m32, cluster or fs2.default_cluster(n_e), 4)
    tensors, B, Tm1 = fs2._forward_batch_inputs("k6", (pol, dpol), D0, m32, f32, fs2.KEYS)
    grid = tuple(m32.state_shape())[:3]
    return fs2._launch_forward_batch(tensors, B, Tm1, D0, m32, 4,
                                     cluster or fs2.batch_cluster_of("household_sweep2", 4, B,
                                                                     grid))


def f64_push_global(pol, D0, model, cluster=None, batch=False):
    """The f64 forward push's global-list instantiation through the
    wrappers' launchers, on `cluster` blocks (default: the wrapper's)."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    n_e = model.heterogeneity["income"].n
    if not batch:
        tensors, Tm1 = fr2._forward_f64_inputs("f64 push", pol, D0, model)
        return fr2._launch_forward(tensors, Tm1, model, fr2.GLOBAL_LISTS,
                                   cluster or fs2.default_cluster(n_e))
    tensors, B, Tm1 = fs2._forward_batch_inputs("f64 push", (pol,), D0, model, f64, fs2.KEYS)
    grid = tuple(model.state_shape())[:3]
    return fr2._launch_forward_batch(
        tensors, B, Tm1, D0, model, fr2.GLOBAL_LISTS,
        cluster or fs2.batch_cluster_of(fr2.LIBRARY, fr2.GLOBAL_LISTS, B, grid))


@pytest.mark.gpu
@pytest.mark.parametrize("n_a", [5, 9, 17, 20])
def test_global_list_forward_kernels_on_card_are_bit_for_bit_the_shared_list_ones(cuda, n_a):
    """At 40×5, 40×9, 40×17 and 40×20 (×5×2, T = 12; seeded, piled, on-knot
    and NaN policies) kernel 6 and the f64 forward push with their lists in
    global memory (launched through the wrappers' launchers with `which`
    the global-list one) are bit for bit the shared-list kernels the
    routes launch there, on their default clusters and on smaller ones; at
    B = 4 the batched global-list kernels are the batched shared-list ones
    and each row a single global-list launch."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    model = two_asset_on(cuda, 40, n_a)
    m32 = fs2.cast_model(model, f32)
    assert fs2.forward_kernel(fs2.KERNEL6, 40, n_a, 5) == 2
    assert fs2.forward_kernel(fs2.F64_PUSH, 40, n_a, 5) == fr2.SHARED_LISTS
    for seed, nan in ((1, False), (2, True)):
        pol, dpol, D0 = two_asset_policies(m32, f32, seed, nan=nan)
        shared = fs2.fused2_forward_jvp(pol, dpol, D0, m32)
        for C in (10, 5, 3):
            assert outputs_same_bits(k6_global(pol, dpol, D0, m32, C),
                                     shared), (seed, C)
        assert all(bool(torch.isnan(v).any()) == nan for v in shared[0].values())
        pol64, _, D064 = two_asset_policies(model, f64, seed, nan=nan)
        shared64 = fr2.fused2_forward_f64(pol64, D064, model)
        for C in (10, 5, 3):
            assert outputs_same_bits((f64_push_global(pol64, D064, model, C),),
                                     (shared64,)), (seed, C)
    polb, dpolb, D0 = two_asset_policies(m32, f32, 3, B=4, nan=True)
    rows = k6_global(polb, dpolb, D0, m32, batch=True)
    assert outputs_same_bits(rows, fs2.fused2_forward_jvp_batch(polb, dpolb, D0, m32))
    for b in range(4):
        single = k6_global(*rows_of((polb, dpolb), b), D0, m32)
        assert outputs_same_bits(rows_of(rows, b), single), b
    pol64, _, D064 = two_asset_policies(model, f64, 3, B=4, nan=True)
    rows64 = f64_push_global(pol64, D064, model, batch=True)
    assert outputs_same_bits((rows64,), (fr2.fused2_forward_f64_batch(pol64, D064, model),))
    for b in range(4):
        single = f64_push_global({k: v[b] for k, v in pol64.items()}, D064, model)
        assert outputs_same_bits(({k: v[b] for k, v in rows64.items()},), (single,)), b


@pytest.mark.gpu
def test_routes_on_card_take_the_global_list_kernels_at_50x70(cuda):
    """At 50×70×5×2 (3500 asset states, T = 12) the wrappers launch the
    global-list instantiations (`.launches_global`), within the plain
    versions' bounds (kernel 6 5e-5·max(scale, 1) of its plain version in
    f64 on the same grids, the f64 push 1e-12), the batched rows bit for
    bit single launches."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    model = two_asset_on(cuda, 50, 70)
    m32 = fs2.cast_model(model, f32)
    pol, dpol, D0 = two_asset_policies(m32, f32, 4)
    counts = (fs2.fused2_forward_jvp.launches, fs2.fused2_forward_jvp.launches_global)
    out = fs2.fused2_forward_jvp(pol, dpol, D0, m32)
    assert (fs2.fused2_forward_jvp.launches, fs2.fused2_forward_jvp.launches_global) == (
        counts[0], counts[1] + 1)
    # The plain version in f64 on the kernel's f32 grids (a policy drawn on a
    # knot stays on it).
    ref = fs2.fused2_forward_jvp_reference({k: v.double() for k, v in pol.items()},
                                           {k: v.double() for k, v in dpol.items()},
                                           D0.double(), m32)
    scale = max(float(r[k].abs().max()) for r in ref for k in r)
    err = max(float((o[k].double() - r[k]).abs().max()) for o, r in zip(out, ref) for k in r)
    assert err <= 5e-5 * max(scale, 1.0)
    pol64, _, D064 = two_asset_policies(model, f64, 4)
    counts = fr2.fused2_forward_f64.launches_global
    out64 = fr2.fused2_forward_f64(pol64, D064, model)
    assert fr2.fused2_forward_f64.launches_global == counts + 1
    ref64 = fr2.fused2_forward_f64_reference(pol64, D064, model)
    assert max(float((out64[k] - ref64[k]).abs().max()) for k in ref64) <= 1e-12
    polb, dpolb, D0 = two_asset_policies(m32, f32, 5, B=4)
    rows = fs2.fused2_forward_jvp_batch(polb, dpolb, D0, m32)
    for b in range(4):
        assert outputs_same_bits(rows_of(rows, b),
                                 fs2.fused2_forward_jvp(*rows_of((polb, dpolb), b), D0, m32))
    pol64, _, D064 = two_asset_policies(model, f64, 5, B=4)
    rows64 = fr2.fused2_forward_f64_batch(pol64, D064, model)
    for b in range(4):
        single = fr2.fused2_forward_f64({k: v[b] for k, v in pol64.items()}, D064, model)
        assert outputs_same_bits(({k: v[b] for k, v in rows64.items()},), (single,)), b


def two_asset_prices(model, dtype, seed):
    """Seeded (T-1,) prices (r, ra, w, tau) and tangents near the two-asset
    steady state, and a V_T (marginal values of a consumption rule rising in
    both assets and income) shaped as the EGM meets it."""
    het = model.heterogeneity
    dev = het["liquid"].grid.device
    rng = np.random.default_rng(seed)
    Tm1 = model.compspec.T - 1
    level = np.array([0.01, 0.03, 0.8, 0.3])[:, None]
    prices = level * (1.0 + 0.05 * rng.random((4, Tm1)))
    tangents = 1e-3 * rng.normal(size=(4, Tm1))
    b, a, z = (het[k].grid.cpu().numpy() for k in ("liquid", "illiquid", "income"))
    c = 0.3 + 0.04 * b[:, None, None] + 0.01 * a[None, :, None] + 0.5 * z[None, None, :]
    c = c[..., None] * np.array([1.0, 1.05])                 # (n_b, n_a, n_e, access)
    VT = np.stack([1.01 * c ** -2.0, 1.03 * 0.95 * c ** -2.0])

    def t(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    return [t(q) for q in prices], [t(q) for q in tangents], t(VT)


def household_prices(model, seed):
    """The model's steady-state prices at its yaml guesses (r, ra, w, tau)
    with 1% seeded noise over T-1 periods, small seeded tangents, and the
    household's converged value there (the port's steady-state pipeline at
    fixed prices: the V_T a path solve starts from)."""
    from hank_tpu_torch.solvers.steady_state import make_ss_pipeline

    spec = model.ss_initial
    _, household, free = make_ss_pipeline(model, spec)
    dev = model.heterogeneity["liquid"].grid.device
    xvec, value, _, _ = household(torch.tensor([spec.guesses[k] for k in free], dtype=f64,
                                               device=dev))
    at = dict(zip(model.var_names(), xvec.tolist()))
    rng = np.random.default_rng(seed)
    Tm1 = model.compspec.T - 1
    prices = [torch.tensor(at[k] * (1.0 + 0.01 * rng.normal(size=Tm1)), dtype=f64, device=dev)
              for k in ("r", "ra", "w", "tau")]
    tangents = [torch.tensor(1e-3 * rng.normal(size=Tm1), dtype=f64, device=dev)
                for _ in range(4)]
    return prices, tangents, value.contiguous()


@pytest.mark.gpu
def test_untabled_backward_kernels_on_card(cuda):
    """Kernel 5 and the f64 backward recursion untabled (the branch they take
    where the brackets' table has no room; `untabled=True` of their
    launchers) are bit for bit their tabled launches at 40×20×5×2 (seeded
    inputs), and at 50×70×5×2 (untabled by the routes: T = 12, the
    household's value and prices at the yaml's steady-state guesses) within
    their plain versions' bounds: kernel 5's policies 5e-5·max(scale, 1) of
    the plain version in f64, the f64 backward 1e-10·max(scale, 1). On the
    seeded synthetic prices and V_T at 50×70 (seed 7), where the plain
    version in f32 is itself past 5e-5·scale (`tests/
    test_torch_fused2_large_grid.py::test_seeded_prices_put_the_plain_f32_
    backward_past_the_card_bound`), kernel 5 is within twice the plain f32
    version's error of the plain version in f64."""
    from hank_tpu_torch.ops import cuda_build
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from hank_tpu_torch.ops import fused_sweep2 as fs2

    model = two_asset_on(cuda, 40, 20)
    m32 = fs2.cast_model(model, f32)
    prices, tangents, VT = two_asset_prices(model, f32, 6)
    assert cuda_build.sweep2_smem_bytes(3, 40, 20, 5, 5) > cuda_build.sweep2_smem_bytes(
        5, 40, 20, 5, 5)                                     # tabled at 40x20
    tabled = fs2.fused2_policies_jvp(*prices, *tangents, VT, m32)
    assert outputs_same_bits(fs2._launch_bwd_cluster(
        (*prices, *tangents), VT, m32, fs2.default_bwd_cluster(5), untabled=True),
                             tabled)
    p64, _, VT64 = two_asset_prices(model, f64, 6)
    assert outputs_same_bits((fr2._launch_policies(p64, VT64, model, untabled=True),),
                             (fr2.fused2_policies_f64(*p64, VT64, model),))

    model = two_asset_on(cuda, 50, 70)
    m32 = fs2.cast_model(model, f32)
    assert cuda_build.sweep2_smem_bytes(3, 50, 70, 5, 5) == cuda_build.sweep2_smem_bytes(
        5, 50, 70, 5, 5)                                     # untabled at 50x70
    p64, tangents, VT64 = household_prices(model, 7)
    prices, VT = [q.to(f32) for q in p64], VT64.to(f32)
    pol, _ = fs2.fused2_policies_jvp(*prices, *(q.to(f32) for q in tangents), VT, m32)
    ref, _ = fs2.fused2_policies_jvp_reference(*(q.double() for q in prices), *tangents,
                                               VT.double(), model)
    scale = max(float(r.abs().max()) for r in ref.values())
    assert max(float((pol[k].double() - ref[k]).abs().max()) for k in ref) <= \
        5e-5 * max(scale, 1.0)
    seeded, seeded_t, seeded_VT = two_asset_prices(model, f32, 7)
    pol, _ = fs2.fused2_policies_jvp(*seeded, *seeded_t, seeded_VT, m32)
    ref, _ = fs2.fused2_policies_jvp_reference(*(q.double() for q in (*seeded, *seeded_t)),
                                               seeded_VT.double(), model)
    ref32, _ = fs2.fused2_policies_jvp_reference(*seeded, *seeded_t, seeded_VT, m32)
    plain32 = max(float((ref32[k].double() - ref[k]).abs().max()) for k in ref)
    assert max(float((pol[k].double() - ref[k]).abs().max()) for k in ref) <= 2 * plain32
    pol64 = fr2.fused2_policies_f64(*p64, VT64, model)
    ref64 = fr2.fused2_policies_f64_reference(*p64, VT64, model)
    scale = max(float(r.abs().max()) for r in ref64.values())
    assert max(float((pol64[k] - ref64[k]).abs().max()) for k in ref64) <= \
        1e-10 * max(scale, 1.0)
