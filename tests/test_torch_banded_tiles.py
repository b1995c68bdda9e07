"""The packed tiles that the banded kernel reads (ops/banded.py BandTiles),
on the CPU, against the JAX package's banded layout and scipy.

The CUDA kernel (csrc/banded.cu) reads only each row's nonempty 128-byte
tiles.  Here, with no card: the tiles unpack to the dense blocks bit for
bit (and so to the JAX package's blocks); their count is the occupancy
computed independently from the scipy sparsity pattern; and a plain torch
product over the tiles, in the kernel's summation order, is held to
`banded_matmat_reference` (which computes from the dense blocks) within
ops.matvec.gap_tolerance(W), while the same product on TF32- and
bf16-rounded inputs falls outside it (bf16 blocks in the plain layout round
x and their products to bf16, as the JAX package's banded_matmat does; there
the product without those roundings must fall outside it).  Operators: RCM-banded random
patterns, square (g = R), wide (g = 2R) and tall (g = R/2), both window
layouts, R = 128 (the production row block) and R = 48 (R/8 warps no
multiple of 4), with a ragged last row block and windows off both ends.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from meshdqn_tpu.ops import banded as jbanded
from meshdqn_tpu_torch.ops import banded as tb
from meshdqn_tpu_torch.ops import matvec as mv
from tests.torch_helpers import cap_threads

cap_threads()

F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
JDT = {F32: jnp.float32, F64: jnp.float64, BF16: jnp.bfloat16}
# Integer views of each dtype, for comparing bits.
BITS = {F32: torch.int32, BF16: torch.int16, F64: torch.int64}
N = 600  # rows of the square operator: 4.7 row blocks of 128
R = 128


def operator(kind, seed):
    A = sp.random(N, N, density=0.02, random_state=seed, format="csr")
    A = (A + A.T + sp.eye(N)).tocsr()
    perm = tb.rcm_permutation(A)
    A = A[perm][:, perm].tocsr()
    return {"square": A, "wide": A[: N // 2, :], "tall": A[:, : N // 2]}[kind].tocsr()


def unpack(tiles, B, R):
    """The dense (B, R, W) blocks the tiles stand for, zero elsewhere."""
    n_tiles, T = tiles.values.shape
    n_rows = tiles.offsets.numel() - 1
    row = torch.repeat_interleave(torch.arange(n_rows), tiles.offsets.long().diff())
    dense = torch.zeros(n_rows, tiles.width // T, T, dtype=tiles.values.dtype)
    dense[row, tiles.cols.long()] = tiles.values
    return dense.reshape(B, R, tiles.width)


def tiled_product(tiles, X, *, R, pad, g, aligned, n_rows, rounded=None):
    """Plain torch product over the packed tiles, in the kernel's order:
    lane c8 of a row sums its N entries of each of the row's tiles, tile
    after tile, and the 8 lanes of a row are added by the xor tree (4, 2,
    1).  bf16 tiles in the plain layout take x rounded to bf16 and round
    each product to bf16, as the kernel does (`rounded`, by default that
    rule, overrides it)."""
    acc = F64 if tiles.values.dtype == F64 else F32
    if rounded is None:
        rounded = tiles.values.dtype == BF16 and not aligned
    V = tiles.values.to(acc)
    X2 = (X[:, None] if X.dim() == 1 else X).to(acc)
    if rounded:
        X2 = X2.bfloat16().to(acc)
    n_cols, m = X2.shape
    n_tiles, T = V.shape
    n_vec = 16 // tiles.values.element_size()  # entries of one 16-byte load
    off = tiles.offsets.long()
    n_band = off.numel() - 1
    row = torch.repeat_interleave(torch.arange(n_band), off.diff())
    b = row // R
    start = ((b * g) // 128 * 128 if aligned else b * g) - pad
    idx = (start + tiles.cols.long() * T)[:, None] + torch.arange(T)  # (n_tiles, T)
    inside = (idx >= 0) & (idx < n_cols)
    xt = X2[idx.clamp(0, n_cols - 1)] * inside[..., None]  # (n_tiles, T, m)
    prod = V[..., None] * xt
    if rounded:
        prod = prod.bfloat16().to(acc)
    prod = prod.view(n_tiles, T // n_vec, n_vec, m)
    lanes = torch.zeros(n_band, T // n_vec, m, dtype=acc)
    rank = torch.arange(n_tiles) - off[row]  # the tile's place in its row
    for step in range(int(rank.max()) + 1 if n_tiles else 0):
        sel = rank == step
        for n in range(n_vec):
            lanes[row[sel]] += prod[sel, :, n]
    s = lanes[:, :4] + lanes[:, 4:]
    s = s[:, :2] + s[:, 2:]
    Y = (s[:, 0] + s[:, 1])[:n_rows]
    return Y[:, 0] if X.dim() == 1 else Y


LAYOUTS = [(kind, aligned) for kind in ("square", "wide", "tall")
           for aligned in (False, True)]
RS = [128, 48]


@pytest.fixture(scope="module")
def built():
    """(A, port BandedMatrix, JAX BandedMatrix, tiles from the layout's
    pairs) by (dtype, kind, aligned, R)."""
    out = {}
    for kind, aligned in LAYOUTS:
        A = operator(kind, seed=11)
        for R in RS:
            flat, vals, B, W, _, _ = tb.banded_layout(A, R, aligned128=aligned)
            for dtype in (F32, BF16, F64):
                t = tb.BandedMatrix.from_scipy(A, device="cpu", dtype=dtype, R=R,
                                               aligned128=aligned)
                j = jbanded.BandedMatrix.from_scipy(A, dtype=JDT[dtype], R=R,
                                                    device_build=False,
                                                    aligned128=aligned)
                v = torch.as_tensor(vals.astype(np.float32) if dtype == F32 else vals)
                tiles = tb.BandTiles.from_pairs(flat, v.to(dtype), (B, R, W))
                out[dtype, kind, aligned, R] = (A, t, j, tiles)
    return out


@pytest.mark.parametrize("kind,aligned", LAYOUTS)
def test_operators_cover_the_edges(built, kind, aligned):
    """The cases hold a ragged last row block and windows off both ends."""
    for R in RS:
        A, t, _, _ = built[F32, kind, aligned, R]
        B, _, W = t.blocks.shape
        starts = tb.window_starts(B, t.g, aligned) - t.pad
        assert A.shape[0] % R and starts[0] < 0 and starts[-1] + W > A.shape[1]


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("dtype", [F32, BF16, F64])
@pytest.mark.parametrize("kind,aligned", LAYOUTS)
def test_tiles_unpack_to_the_blocks(built, dtype, kind, aligned, R):
    _, t, j, tiles = built[dtype, kind, aligned, R]
    B, _, W = t.blocks.shape
    assert tiles.values.dtype == dtype and tiles.width == W
    assert tiles.values.shape[1] == tb.TILE_BYTES // t.blocks.element_size()
    dense = unpack(tiles, B, R)
    assert torch.equal(dense.view(BITS[dtype]), t.blocks.view(BITS[dtype]))
    jb = np.asarray(j.blocks)
    np.testing.assert_array_equal(dense.double().numpy(), jb.astype(np.float64))
    # The tiles made from the blocks alone (the path of operators carried
    # across from the JAX package) and from_scipy's are the same tiles.
    again = tb.BandTiles.from_blocks(t.blocks)
    for name in ("values", "offsets", "cols"):
        assert torch.equal(getattr(again, name), getattr(tiles, name))
        assert torch.equal(getattr(t.tiles, name), getattr(tiles, name))


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("dtype", [F32, BF16, F64])
@pytest.mark.parametrize("kind,aligned", LAYOUTS)
def test_tile_count_is_the_pattern_occupancy(built, dtype, kind, aligned, R):
    """Nonempty tiles counted from the scipy pattern and the JAX layout's
    window starts, row by row."""
    A, t, j, tiles = built[dtype, kind, aligned, R]
    coo = A.tocoo()
    T = 128 // t.blocks.element_size()
    b = coo.row // R
    s = (b * j.g // 128) * 128 if aligned else b * j.g
    window_col = coo.col - s + j.pad
    pattern = set(zip(coo.row.tolist(), (window_col // T).tolist()))
    assert tiles.values.shape[0] == len(pattern)
    per_row = np.bincount([q for q, _ in pattern], minlength=tiles.offsets.numel() - 1)
    np.testing.assert_array_equal(tiles.offsets.diff().numpy(), per_row)
    B, _, W = t.blocks.shape
    assert tiles.offsets.numel() == B * R + 1
    assert tiles.occupancy == pytest.approx(len(pattern) / (B * R * (W // T)))
    assert tiles.nbytes == (tiles.values.numel() * t.blocks.element_size()
                            + 4 * (tiles.offsets.numel() + len(pattern)))
    assert t.read_bytes(2) == tiles.nbytes + 2 * sum(A.shape) * (8 if dtype == F64 else 4)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", [F32, BF16, F64])
@pytest.mark.parametrize("kind,aligned", LAYOUTS)
def test_tiled_product_matches_plain_version(built, dtype, kind, aligned, m, R):
    A, t, _, tiles = built[dtype, kind, aligned, R]
    xdt = F64 if dtype == F64 else F32
    X = torch.tensor(np.random.default_rng(m).standard_normal(
        (A.shape[1],) if m == 1 else (A.shape[1], m)), dtype=xdt)
    kw = dict(pad=t.pad, g=t.g, aligned=aligned, n_rows=A.shape[0])
    yp = tb.banded_matmat_reference(t.blocks, X, **kw)
    y = tiled_product(tiles, X, R=R, **kw)
    tol = mv.gap_tolerance(t.blocks.shape[2], xdt)
    assert y.shape == yp.shape and mv.relative_gap(y, yp) <= tol
    # On CPU tensors the wrapper is the plain version.
    assert torch.equal(tb.banded_matmat(t, X), yp)
    if dtype == BF16 and not aligned:
        # x and the products are rounded to bf16 here, so rounding the
        # inputs changes nothing: the check must reject x kept in f32 with
        # exact products, and x rounded with exact products.
        for x in (X, X.bfloat16().float()):
            assert mv.relative_gap(tiled_product(tiles, x, R=R, rounded=False, **kw),
                                   yp) > tol
        return
    # The check rejects a product that lost precision.
    for bits in (10, 7):
        # bf16 values keep 7 mantissa bits, so they round back exactly.
        values = mv.round_mantissa(tiles.values.to(xdt), bits).to(dtype)
        rounded = tb.BandTiles(values=values, offsets=tiles.offsets,
                               cols=tiles.cols, width=tiles.width)
        yr = tiled_product(rounded, mv.round_mantissa(X, bits), R=R, **kw)
        assert mv.relative_gap(yr, yp) > tol


def _tiles():
    A = operator("square", seed=12)
    return tb.BandedMatrix.from_scipy(A, device="cpu", dtype=F32, R=R).tiles


@pytest.mark.parametrize("fault", ["falling", "short_end", "wide_col", "repeat_col",
                                   "int64_offsets", "T"])
def test_malformed_tile_index_is_rejected(fault):
    t = _tiles()
    off, cols, values = t.offsets.clone(), t.cols.clone(), t.values
    first = int(torch.nonzero(off.diff() >= 2)[0])  # a row of two tiles or more
    if fault == "falling":
        off[first + 1] = off[first] - 1 if off[first] > 0 else -1
    elif fault == "short_end":
        off[-1] -= 1
    elif fault == "wide_col":
        cols[0] = t.width // values.shape[1]
    elif fault == "repeat_col":
        cols[off[first] + 1] = cols[off[first]]
    elif fault == "int64_offsets":
        off = off.long()
    else:
        values = values.reshape(-1, 16)
    error = TypeError if fault == "int64_offsets" else ValueError
    with pytest.raises(error):
        tb.BandTiles(values=values, offsets=off, cols=cols, width=t.width)


def test_band_must_cut_into_tiles():
    with pytest.raises(ValueError):  # W = 12 is no multiple of the 32-entry f32 tile
        tb.BandedMatrix(blocks=torch.ones(1, 8, 12), pad=0, g=8, shape=(8, 8))
    with pytest.raises(ValueError):  # R = 4 is no multiple of the kernel's 8-row warp
        tb.BandedMatrix(blocks=torch.ones(1, 4, 128), pad=0, g=4, shape=(4, 4))


def test_operator_holds_its_own_tiles():
    """Blocks and tiles are one frozen operator: neither can be swapped, and
    tiles of another band are refused."""
    import dataclasses

    t = tb.BandedMatrix.from_scipy(operator("square", seed=12), device="cpu", R=R)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.blocks = t.blocks.clone()
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.tiles = t.tiles
    other = tb.BandedMatrix.from_scipy(operator("wide", seed=12), device="cpu", R=R)
    with pytest.raises(ValueError):
        tb.BandedMatrix(blocks=t.blocks, pad=t.pad, g=t.g, shape=t.shape,
                        tiles=other.tiles)
    with pytest.raises(ValueError):  # tiles of the blocks in another dtype
        tb.BandedMatrix(blocks=t.blocks, pad=t.pad, g=t.g, shape=t.shape,
                        tiles=tb.BandTiles.from_blocks(t.blocks.double()))
