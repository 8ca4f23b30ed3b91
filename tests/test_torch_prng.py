"""Dropout masks of the train kernels (madeleine_torch/ops/prng.py): the
Philox4x32-10 generator, the keep rate and mean, and the independence of a
mask from how the tokens are tiled."""

import numpy as np
import pytest
import torch

from madeleine_torch.ops import prng


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """The Random123 known-answer vectors of Philox4x32-10."""
    words = prng.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_keep_rate_and_mean_within_4_sigma(rate):
    """Over 2**20 draws: the kept fraction within 4 sigma of 1 - rate, and the
    mask's mean within 4 sigma of 1 (the scale comes from the threshold)."""
    rows, toks = prng.site_rows(4, 1024, 0, "cpu")
    m = prng.keep_mask(123, rows, toks, 3, 256, rate)
    n = m.numel()
    thr, scale = prng.threshold(rate)
    p = 1.0 - thr / 2 ** 32
    kept = float((m > 0).double().mean())
    assert abs(kept - p) <= 4 * np.sqrt(p * (1 - p) / n)
    assert abs(float(m.double().mean()) - 1.0) <= 4 * scale * np.sqrt(p * (1 - p) / n)
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(scale)}


def test_threshold_rule():
    thr, scale = prng.threshold(0.1)
    assert thr == round(0.1 * 2 ** 32) and scale == 1 / (1 - thr / 2 ** 32)
    assert prng.threshold(0.0) == (0, 1.0)
    assert prng.threshold(1e-12)[0] == 1


def test_masks_do_not_depend_on_tiling_or_batch_position():
    """A mask is a function of (seed, global row, token, stream, column): the
    tokens cut into tiles, or a row taken out of its batch (row offset), give
    the same bits as the whole."""
    rows, toks = prng.site_rows(3, 96, 5, "cpu")
    whole = prng.keep_mask(9, rows, toks, 2, 64, 0.1)
    tiles = torch.cat([prng.keep_mask(9, rows[:, a:b], toks[:, a:b], 2, 64, 0.1)
                       for a, b in ((0, 32), (32, 40), (40, 96))], dim=1)
    assert torch.equal(whole, tiles)
    r1, t1 = prng.site_rows(1, 96, 7, "cpu")                  # global row 7 = row 2 above
    assert torch.equal(prng.keep_mask(9, r1, t1, 2, 64, 0.1)[0], whole[2])


def test_streams_seeds_and_columns_draw_independently():
    rows, toks = prng.site_rows(2, 64, 0, "cpu")
    base = prng.keep_mask(1, rows, toks, 0, 128, 0.25)
    for other in (prng.keep_mask(2, rows, toks, 0, 128, 0.25),
                  prng.keep_mask(1, rows, toks, 1, 128, 0.25),
                  prng.keep_mask(1, rows, toks, prng.gate_stream(0, 1), 128, 0.25)):
        agree = float(((base > 0) == (other > 0)).float().mean())
        assert 0.55 < agree < 0.70                              # 0.75^2 + 0.25^2 = 0.625
    cols = (base > 0).float()
    assert abs(float((cols[..., :64] == cols[..., 64:]).float().mean()) - 0.625) < 0.05
