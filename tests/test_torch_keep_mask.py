"""The keep-mask kernel's work split (fused_dropout_ln.cu
`fdrln_bits_kernel`), mirrored in PyTorch on the CPU.

The kernel gives each lane 4 adjacent columns of one 4-row group: lane t
takes group t / quads and columns 4 (t % quads) .. + 3, quads = ceil(h /
4), the division a multiply-high by the host's magic number (t < 2^31);
it makes one Philox-4x32-10 call a column with the counter (col, group,
tag, offset) and stores word r of a call to row 4 group + r, a whole
group and quad as one 4-byte word a row (bool) where h % 4 == 0, else
element by element. Here the same split, with the same Philox
(`cuda_kernels._philox4x32_10`), must write every element exactly once
and give `dropout_keep_plain`'s mask and `fused_dropout_bits_plain`'s
bits bit for bit, at h = 1, h not a multiple of 4 or 16, n not a
multiple of 4, and the main paths' widths. The kernel itself is held to
the plain mask on the card (chip_smoke.py `check_dropout_keep`).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401  (one intra-op thread a worker)

SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 77


def _magic(d):
    """launch_bits' magic number and shift for t / d, t < 2^31."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _div(t, d):
    magic, shift = _magic(d)
    return (((t * magic) >> 32) + t) >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 9, 33, 192, 375, 4097,
                               2 ** 20 + 7, 2 ** 30 + 1, 2 ** 31 - 1])
def test_magic_division_is_exact_below_2_31(d):
    rs = np.random.RandomState(d % 1000)
    ts = np.concatenate([rs.randint(0, 2 ** 31, 4000, dtype=np.int64),
                         np.arange(0, 2000), [d - 1, d, d + 1, 2 * d - 1,
                                              2 ** 31 - 2, 2 ** 31 - 1]])
    ts = ts[(ts >= 0) & (ts < 2 ** 31)].astype(object)
    magic, _ = _magic(d)
    assert 0 < magic < 2 ** 32
    assert all(_div(int(t), d) == int(t) // d for t in ts)


def _kernel_bits(n, h, tag, mask_thr=None):
    """The kernel's output for rows [n, h] by its own split: int64 bits,
    or the keep mask (bool) when `mask_thr` is given; and how often each
    element was written."""
    quads = (h + 3) // 4
    groups = (n + 3) // 4
    t = torch.arange(groups * quads, dtype=torch.int64)
    magic, shift = _magic(quads)
    group = (((t * magic) >> 32) + t) >> shift
    c0 = (t - group * quads) * 4
    out = torch.zeros(n * h, dtype=torch.int64)
    writes = torch.zeros(n * h, dtype=torch.int64)
    full = lambda v: torch.full_like(t, int(v))  # noqa: E731
    for j in range(4):
        words = ck._philox4x32_10(c0 + j, group, full(tag), full(OFFSET),
                                  SEED & ck._U32, SEED >> 32)
        for r in range(4):
            row, col = group * 4 + r, c0 + j
            live = (row < n) & (col < h)
            idx = (row * h + col)[live]
            out[idx] = words[r][live]
            writes.index_add_(0, idx, torch.ones_like(idx))
    out = out.view(n, h)
    if mask_thr is not None:
        out = out >= mask_thr
    return out, writes.view(n, h)


SHAPES = [(5, 1), (4, 1, 1), (7, 6), (9, 20), (2, 3, 33), (1, 130),
          (13, 1500), (6, 36), (4, 12), (3, 2, 4, 17), (2, 16, 768),
          (2, 128, 8, 8), (20, 35, 1500)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("p", [0.1, 0.65])
def test_split_writes_every_element_once_and_gives_the_plain_mask(shape, p):
    n, h = int(np.prod(shape[:-1])), shape[-1]
    got, writes = _kernel_bits(n, h, ck._KEEP_TAG, ck._threshold(p))
    assert (writes == 1).all()
    want = ck.dropout_keep_plain(SEED, OFFSET, shape, p)
    assert torch.equal(got.view(shape), want)


@pytest.mark.parametrize("shape", SHAPES[:10], ids=lambda s: "x".join(
    map(str, s)))
def test_bits_route_gives_the_plain_bits(shape):
    """mask = 0: the uint32 bits under the fused kernels' tag."""
    n, h = int(np.prod(shape[:-1])), shape[-1]
    got, _ = _kernel_bits(n, h, ck._FDRLN_TAG)
    assert torch.equal(got, ck.fused_dropout_bits_plain(SEED, OFFSET, n, h))


@pytest.mark.parametrize("h", [4, 12, 768])
def test_a_rows_four_bytes_pack_into_one_word(h):
    """A whole group and quad store row r's 4 keep bytes as one
    little-endian word, b0 | b1 << 8 | b2 << 16 | b3 << 24: read back as
    bytes, they are the row's 4 bools in column order."""
    n = 8
    mask, _ = _kernel_bits(n, h, ck._KEEP_TAG, ck._threshold(0.3))
    quads = mask.view(n, h // 4, 4).to(torch.int64)
    word = (quads[..., 0] | quads[..., 1] << 8 | quads[..., 2] << 16
            | quads[..., 3] << 24)
    as_bytes = word.numpy().astype("<u4").view(np.uint8).reshape(n, h)
    np.testing.assert_array_equal(as_bytes.astype(bool), mask.numpy())
