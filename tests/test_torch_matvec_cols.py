"""The matvec kernel's k-column launch shape (ops/matvec.py plan_cols), on
the CPU: the planner's choices at edge shapes and at the ensemble's
products, and an emulation of the kernel's schedule (csrc/matvec.cu
cols_kernel: head classes, row tiles, rows a warp, shifted windows staged
in the kernel's shared-memory layout) that must give, row for row, the bits
of the per-lane order the single form and the earlier k-column form
(tests/test_torch_batch.py) sum in.  The kernel itself is held to k = 1
launches on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import pytest
import torch

from meshdqn_tpu_torch.ops import matvec as mv
from tests.test_torch_batch import _column_order
from tests.torch_helpers import cap_threads

cap_threads()

# Shared memory a block may use on sm_90.
SMEM_LIMIT = 232448

# The ensemble step's seven products at 16 members (solver/ensemble.py;
# chip_smoke.cols_shapes): ys930 (Ns, Np) = (3322, 876), ah93w145 (3025, 797).
ENSEMBLE = [(2 * ns, 2 * ns, 16) for ns in (3322, 3025)] * 2 + [
    shape for ns, npr in ((3322, 876), (3025, 797))
    for shape in ((2 * ns, npr, 16), (2 * ns, npr, 16), (npr, 2 * ns, 16), (npr, npr, 16),
                  (ns, ns, 32))]

EDGE = [(R, N, k) for N in (128, 129, 130, 131, 1029, 1030) for k in (3, 16, 17, 32)
        for R in (1, 37, 301)]


def _head(offset: int, r: int, N: int) -> int:
    """Row r's scalar head: entries up to its first 16-byte boundary, for m
    stored `offset` floats past one."""
    return min((-(offset + r * N)) % 4, N)


@pytest.mark.parametrize("R,N,k", EDGE + ENSEMBLE)
def test_plan_fits_shares_heads_and_covers_every_row_once(R, N, k):
    plan = mv.plan_cols(R, N, k)
    assert plan.kb >= k and plan.kb in (8, 16, 32)
    assert plan.window % 128 == 0 and plan.window % mv.COLS_QUANTUM == 0
    assert plan.window <= mv.COLS_WINDOW_MAX and plan.window < N + mv.COLS_QUANTUM
    assert plan.smem_bytes == 4 * (plan.buffers * plan.window * (plan.kb + 4) + 4 * plan.kb)
    assert plan.smem_bytes <= min(mv.COLS_SMEM_BYTES, SMEM_LIMIT)
    assert (plan.rows_per_warp, plan.depth) in ((4, 2), (1, 8))
    # Registers: rows_per_warp * kb accumulators a lane, at most 128 a thread
    # beside them where the block has 16 warps.
    assert plan.warps <= (8 if plan.kb * plan.rows_per_warp == 128 else 16)
    assert (plan.classes * N) % 4 == 0
    tiles, classes = plan.grid(R)
    seen = []
    for b in range(classes):
        for t in range(tiles):
            block = [plan.rows(R, t, b, w) for w in range(plan.warps)]
            for offset in range(4):  # m one to three floats past a 16-byte boundary
                heads = {_head(offset, r, N) for rows in block for r in rows}
                assert len(heads) <= 1, (b, t, offset, heads)
            for rows in block:
                assert len(rows) <= plan.rows_per_warp
                seen += rows
    assert sorted(seen) == list(range(R))


@pytest.mark.parametrize("R,N,k", ENSEMBLE)
def test_plan_spreads_the_ensemble_rows_over_the_sms(R, N, k):
    """One block an SM, each staging x once for its rows: a tile of about
    R / 132 rows (4 a warp from 8 rows an SM up, else 1), so the grid fills
    more than half the card and no SM takes two blocks."""
    plan = mv.plan_cols(R, N, k)
    tiles, classes = plan.grid(R)
    assert mv.COLS_SMS // 2 < tiles * classes <= mv.COLS_SMS
    assert plan.rows_per_warp == (4 if R >= 8 * mv.COLS_SMS else 1)
    assert plan.staged_bytes(R, N, k) == 4 * N * k * tiles * classes


def test_plan_rejects_what_the_kernel_does_not_take():
    for R, N, k in ((4, 4, 0), (4, 4, 33), (4, 0, 3), (-1, 4, 3)):
        with pytest.raises(ValueError):
            mv.plan_cols(R, N, k)


def _fma(acc: torch.Tensor, m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fmaf(m, x, acc) as the CPU emulations of the kernels take it
    (tests/test_torch_ops.py _kernel_order): the exact f64 product and sum,
    rounded once to f32."""
    return (acc.double() + m * x).float()


def _window_index(kb: int, p, j):
    """Float index of X's column j at window position p in cols_kernel's
    shared memory: chunk j // 4 of position p at float4 p (kb / 4 + 1) +
    (j // 4 ^ swizzle(p)), swizzle(p) = (p // 8) & 3 (& 1 at kb = 8)."""
    swizzle = (p >> 3) & (3 if kb >= 16 else 1)
    return 4 * (p * (kb // 4 + 1) + ((j >> 2) ^ swizzle)) + (j & 3)


def _schedule_order(M: torch.Tensor, X: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Y = M @ X as cols_kernel sums it for M stored `offset` floats past a
    16-byte boundary: per launch of up to COLS_MAX columns, plan_cols'
    blocks; per block, the class's head h, X's head rows and each window
    staged into emulated shared memory by the kernel's indexing (unstaged
    slots hold NaN, so a read of one shows), and each warp's rows summed
    lane by lane: head (window 0), float4s v = lane, lane + 32, ... of each
    window, position by position, read at `_window_index`, the tail in the
    window that holds position 4 nvec; then the xor tree."""
    R, N = M.shape
    k = X.shape[1]
    Y = torch.full((R, k), float("nan"))
    for c_lo in range(0, k, mv.COLS_MAX):
        kc = min(mv.COLS_MAX, k - c_lo)
        plan = mv.plan_cols(R, N, kc)
        kb, W = plan.kb, plan.window
        x = X[:, c_lo:c_lo + kc]
        tiles, classes = plan.grid(R)
        for b in range(classes):
            for t in range(tiles):
                rows = [r for w in range(plan.warps) for r in plan.rows(R, t, b, w)]
                if not rows:
                    continue
                h = _head(offset, rows[0], N)
                span, j = N - h, torch.arange(kc)
                nvec, ntail = span // 4, span % 4
                head = torch.full((4 * kb,), float("nan"))
                for e in range(h):
                    head[e * kb + j] = x[e]
                m64 = M[rows].double()
                lanes = torch.zeros(len(rows), 32, kc)
                for wi in range(max(1, -(-span // W))):
                    s0 = wi * W
                    buf = torch.full((W * (kb + 4),), float("nan"))
                    p = torch.arange(min(W, span - s0))
                    buf[_window_index(kb, p[:, None], j).flatten()] = x[h + s0 + p].flatten()
                    if wi == 0:
                        for ln in range(h):
                            lanes[:, ln] = _fma(lanes[:, ln], m64[:, ln, None],
                                                head[ln * kb + j].double())
                    vb = s0 // 4
                    ve = min(vb + W // 4, nvec)
                    for v0 in range(vb, ve, 32):
                        v = torch.arange(v0, min(v0 + 32, ve))
                        ln = v - v0
                        for e in range(4):
                            xv = buf[_window_index(kb, 4 * (v - vb)[:, None] + e, j)]
                            lanes[:, ln] = _fma(lanes[:, ln], m64[:, h + 4 * v + e, None],
                                                xv.double())
                    if ntail and s0 <= 4 * nvec < s0 + W:
                        for ln in range(ntail):
                            xv = buf[_window_index(kb, 4 * nvec - s0 + ln, j)]
                            lanes[:, ln] = _fma(lanes[:, ln],
                                                m64[:, h + 4 * nvec + ln, None], xv.double())
                for off in (16, 8, 4, 2, 1):
                    lanes = lanes + lanes[:, torch.arange(32) ^ off]
                Y[rows, c_lo:c_lo + kc] = lanes[:, 0]
    return Y


def _k1_order(M: torch.Tensor, x: torch.Tensor, offset: int) -> torch.Tensor:
    """The single form's k = 1 order (tests/test_torch_ops.py _kernel_order)
    for M stored `offset` floats past a 16-byte boundary."""
    R, N = M.shape
    heads = torch.tensor([_head(offset, r, N) for r in range(R)])
    y = torch.empty(R)
    for h in heads.unique().tolist():
        rows = heads == h
        m64, x64 = M[rows].double(), x.double()
        lanes = torch.zeros(m64.shape[0], 32)
        fma = lambda cols, ids: lanes.__setitem__(
            (slice(None), ids), (lanes[:, ids].double() + m64[:, cols] * x64[cols]).float())
        fma(torch.arange(h), torch.arange(h))
        nvec = (N - h) // 4
        for v0 in range(0, nvec, 32):
            v = torch.arange(v0, min(v0 + 32, nvec))
            for e in range(4):
                fma(h + 4 * v + e, v - v0)
        tail = torch.arange(h + 4 * nvec, N)
        fma(tail, tail - h - 4 * nvec)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, torch.arange(32) ^ off]
        y[rows] = lanes[:, 0]
    return y


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("R,N,k", [(37, 1028, 16), (37, 1029, 3), (45, 1030, 32),
                                   (29, 1031, 17), (13, 3, 40), (9, 1, 16),
                                   (70, 600, 16)])
def test_schedule_gives_the_per_lane_order_row_for_row(R, N, k, offset):
    """Every row of the emulated schedule equals the per-lane emulation
    (tests/test_torch_batch.py _column_order, M on a 16-byte boundary) and,
    column by column, the k = 1 order at M's offset, bit for bit: rows with
    each head, windows staged at their class's shift, ragged tiles, a
    40-column split (two launches, x and y rows 40 apart)."""
    g = torch.Generator().manual_seed(R * 7 + N + k + offset)
    M, X = torch.randn(R, N, generator=g), torch.randn(N, k, generator=g)
    Y = _schedule_order(M, X, offset)
    if offset == 0:
        assert torch.equal(Y, _column_order(M, X))
    for j in range(k):
        assert torch.equal(Y[:, j], _k1_order(M, X[:, j], offset)), j
