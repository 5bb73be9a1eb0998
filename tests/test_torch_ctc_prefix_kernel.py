"""The CTC prefix kernel's wrapper: on CPU tensors its plain version, with
no launch counted; on the card (marked ``cuda``, skipped without one) the
kernel against the plain version. The file imports no JAX, so its card
test runs on a machine with a card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_ctc_prefix_kernel.py

The plain version itself is held to the JAX package on the CPU by
``test_torch_ctc_prefix.py``.
"""

import pytest
import torch

from stac_st_tpu_torch.decoding import ctc_prefix as P
from stac_st_tpu_torch.ops import kernels
from stac_st_tpu_torch.ops.kernels.ctc_prefix import (
    ctc_prefix_score,
    ctc_prefix_score_ref,
)

BLANK, EOS = 0, 2
NEG_CLASS = -1e8


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    """A mid prefix (one score and select) of B 2 x beam 3, T 13, V 12,
    eos and blank among the candidates, lengths below T."""
    g = torch.Generator().manual_seed(5)
    b, beam, t, v = 2, 3, 13, 12
    lp = torch.log_softmax(2 * torch.randn((b, t, v), generator=g), -1)
    lens = torch.tensor([13, 9, 13, 13, 5, 11])
    cand = torch.randint(3, v, (b * beam, 4), generator=g)
    cand[:, 0], cand[:, 1] = EOS, BLANK
    state = P.ctc_prefix_init(lp, BLANK, beam)
    kernels.reset_launches()
    _, cs, cid = P.ctc_prefix_score_all(state, lp, lens, BLANK, EOS, cand,
                                        beam)
    mid = P.ctc_prefix_select(cs, cid, torch.full((b * beam,), 3))
    args = (lp, mid.r_nb, mid.r_b, mid.last, cand, lens, BLANK, EOS, beam)
    got = ctc_prefix_score(*args)
    assert kernels.launches == {}
    for x, w in zip(got, ctc_prefix_score_ref(*args)):
        assert torch.equal(x, w)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: the search's
    shapes at a small size (B 2 x beam 5, T 60, V 300, K 6), half the rows
    mid-prefix, lengths below T, eos, blank and the last label among the
    candidates, then full-vocabulary mode; within 1e-4 of max(1, |plain|),
    the -1e9 class in the same places, bitwise over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(3)
    b, beam, t, v = 2, 5, 60, 300
    bb = b * beam
    lp = torch.log_softmax(2 * torch.randn((b, t, v), generator=g), -1)
    state = P.ctc_prefix_init(lp, BLANK, beam)
    cand = torch.randint(3, v, (bb, 6), generator=g)
    lens = torch.randint(t // 2, t + 1, (bb,), generator=g)
    _, cs, _ = P.ctc_prefix_score_all(state, lp, lens, BLANK, EOS, cand,
                                      beam)
    mid = P.ctc_prefix_select(cs, cand, torch.arange(bb) % 6)
    last = torch.where(torch.arange(bb) % 2 == 0, state.last, mid.last)
    keep = (torch.arange(bb) % 2 == 0)[:, None]
    r_nb = torch.where(keep, state.r_nb, mid.r_nb)
    r_b = torch.where(keep, state.r_b, mid.r_b)
    cand[:, 0], cand[:, 1], cand[:, 2] = EOS, BLANK, last.clamp(min=3)
    for c in (cand, None):
        args = [lp, r_nb, r_b, last, c, lens]
        want = ctc_prefix_score_ref(*args, BLANK, EOS, beam)
        dev = [a if a is None else a.cuda() for a in args]
        one = ctc_prefix_score(*dev, BLANK, EOS, beam)
        two = ctc_prefix_score(*dev, BLANK, EOS, beam)
        torch.cuda.synchronize()
        for g1, g2, w in zip(one, two, want):
            assert torch.equal(g1, g2)
            g1 = g1.cpu()
            neg = w <= NEG_CLASS
            assert torch.equal(g1 <= NEG_CLASS, neg)
            tol = 1e-4 * w.abs().clamp(min=1.0)
            assert ((g1 - w).abs() <= tol)[~neg].all()
