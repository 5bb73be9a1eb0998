"""Port front end against JAX: fbank, CMVN apply, conv front end.

Inputs are made with numpy from a seed; tolerance fp32, atol 1e-4.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.models import ConvolutionFrontEnd as JaxCNN
from stac_st_tpu.ops.cmvn import CmvnState as JaxCmvnState
from stac_st_tpu.ops.cmvn import cmvn_apply as jax_cmvn_apply
from stac_st_tpu.ops.fbank import Fbank as JaxFbank
from stac_st_tpu_torch.interop.from_jax import cmvn_from_jax, load_jax_params
from stac_st_tpu_torch.models import ConvolutionFrontEnd
from stac_st_tpu_torch.ops.cmvn import cmvn_apply
from stac_st_tpu_torch.ops.fbank import Fbank

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def audio():
    """Two utterances 60 dB apart in loudness, the quiet one zero-padded:
    the batch-global top_db clamp then binds on the quiet row."""
    rng = np.random.default_rng(11)
    L = 8000
    loud = rng.standard_normal(L).astype(np.float32)
    quiet = np.zeros(L, np.float32)
    quiet[:5000] = 1e-3 * rng.standard_normal(5000)
    return np.stack([loud, quiet])


@pytest.fixture(scope="module")
def cmvn():
    rng = np.random.default_rng(12)
    return JaxCmvnState(
        mean=jnp.asarray(rng.standard_normal(80) * 5.0, jnp.float32),
        std=jnp.asarray(1.0 + 3.0 * rng.random(80), jnp.float32),
        count=jnp.asarray(3.0, jnp.float32))


def test_fbank_matches_jax_with_batch_global_clamp(audio):
    ref = np.asarray(JaxFbank()(jnp.asarray(audio)))
    fb = Fbank()
    got = fb(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, fb.output_frames(8000), 80)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # the clamp is taken over the whole batch: the quiet utterance alone
    # gets other features than inside the batch, in both packages
    alone = fb(torch.from_numpy(audio[1:])).numpy()[0]
    alone_ref = np.asarray(JaxFbank()(jnp.asarray(audio[1:])))[0]
    np.testing.assert_allclose(alone, alone_ref, atol=ATOL, rtol=0)
    assert np.abs(alone - got[1]).max() > 1.0
    assert np.isclose(got[1].min(), got.max() - 80.0, atol=ATOL)


def test_cmvn_apply_matches_jax(audio, cmvn):
    feats = np.array(JaxFbank()(jnp.asarray(audio)))
    ref = np.asarray(jax_cmvn_apply(cmvn, jnp.asarray(feats)))
    got = cmvn_apply(cmvn_from_jax(cmvn), torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_pcm_to_conv_features_match_jax(audio, cmvn):
    """PCM -> fbank -> CMVN -> CNN (16, 16): the conv layout (NHWC with
    H = time, W = freq) and the LayerNorm over (freq, channel) agree with
    JAX."""
    cnn_j = JaxCNN(out_channels=(16, 16))
    feats_j = jax_cmvn_apply(cmvn, JaxFbank()(jnp.asarray(audio)))
    shapes = jax.eval_shape(cnn_j.init, jax.random.PRNGKey(0), feats_j)
    rng = np.random.default_rng(13)
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.3 * rng.standard_normal(s.shape)
                              + (1.0 if len(s.shape) == 2 else 0.0),
                              jnp.float32),
        shapes)
    ref = np.asarray(jax.jit(cnn_j.apply)(params, feats_j))

    cnn = ConvolutionFrontEnd(out_channels=(16, 16))
    load_jax_params({"CNN": jax.tree_util.tree_map(np.asarray, params)},
                    cnn=cnn)
    with torch.no_grad():
        feats = cmvn_apply(cmvn_from_jax(cmvn),
                           Fbank()(torch.from_numpy(audio)))
        got = cnn(feats).numpy()
    assert got.shape == ref.shape == (2, 13, 20, 16)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
