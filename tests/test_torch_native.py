"""The port's native host library (``csrc/stacnative.cpp`` through
``stac_st_tpu_torch.native``) against the numpy and pure-Python paths the
JAX package runs when its own extension is not built (it is not built
here, so those paths are its reference).

Decoders are held bitwise (``array_equal`` on the float32 bits), BPE ids
exactly (on a model from ``train_bpe`` with the turn and language
symbols), the resampler to scipy by the JAX test's criterion (correlation
above 0.9999 away from the edges), and edit statistics by their totals.
Builds go to temporary folders; no JAX program is built.
"""

import os
import threading

import numpy as np
import pytest

from stac_st_tpu.data import audio as jaudio
from stac_st_tpu.tokenizer import BpeEncoder as JBpeEncoder
from stac_st_tpu.utils.edit_distance import (
    align_edit_distance as j_align_edit_distance,
)

from stac_st_tpu_torch import native
from stac_st_tpu_torch.data import audio
from stac_st_tpu_torch.tokenizer import BpeEncoder, train_bpe
from stac_st_tpu_torch.tokenizer.bpe import normalize_text
from stac_st_tpu_torch.utils.edit_distance import align_edit_distance


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_pcm16_matches_numpy_bitwise():
    rng = np.random.default_rng(0)
    for big_endian in (False, True):
        dtype = ">i2" if big_endian else "<i2"
        pcm = np.concatenate([
            np.array([-32768, -1, 0, 1, 32767], np.int64),
            rng.integers(-32768, 32768, 20000)]).astype(dtype)
        data = pcm.tobytes()
        got = audio._pcm16_bytes(data, big_endian)
        ref = jaudio._pcm_to_float(np.frombuffer(data, dtype), 16)
        assert np.array_equal(_bits(got), _bits(ref))
        assert np.array_equal(_bits(got), _bits(
            audio._pcm16_bytes_plain(data, big_endian)))


@pytest.mark.parametrize("law", ["ulaw", "alaw"])
def test_law_decoders_match_numpy_bitwise(law):
    """Every byte value, then seeded noise; the readers take the library's
    decoder."""
    raw = np.concatenate([np.arange(256), np.random.default_rng(1).integers(
        0, 256, 5000)]).astype(np.uint8)
    decode = getattr(jaudio, f"_{law}_decode")
    ref = jaudio._pcm_to_float(decode(raw), 16)
    got = getattr(audio, f"_{law}_bytes")(raw.tobytes())
    assert getattr(audio, f"_{law}_bytes") is getattr(native,
                                                       f"{law}_to_float")
    assert np.array_equal(_bits(got), _bits(ref))


def test_resample_poly_matches_scipy():
    from scipy.signal import resample_poly

    x = np.sin(np.linspace(0, 80, 16000)).astype(np.float32)
    for up, down in ((1, 2), (2, 1)):
        y = native.resample_poly(x, up, down)
        ref = resample_poly(x.astype(np.float64), up, down).astype(np.float32)
        assert len(y) == len(ref)
        n = len(y)
        corr = np.corrcoef(y[200:n - 200], ref[200:n - 200])[0, 1]
        assert corr > 0.9999


def test_edit_stats_totals_match_align_edit_distance():
    rng = np.random.default_rng(2)
    vocab = ["a", "b", "c", "d", "e", "ñu"]
    for _ in range(40):
        ref = [vocab[i] for i in rng.integers(0, 6, rng.integers(0, 12))]
        hyp = [vocab[i] for i in rng.integers(0, 6, rng.integers(0, 12))]
        total = sum(native.edit_stats(ref, hyp))
        assert total == sum(j_align_edit_distance(ref, hyp)[:3])
        assert total == sum(align_edit_distance(ref, hyp)[:3])


def test_bpe_ids_equal_the_pure_python_encoder():
    """The port's encoder (the library's merge loop) gives the pure-Python
    loop's ids and the JAX package's, user-defined symbols included."""
    corpus = ["hola como estas [turn] muy bien", "hello how are you",
              "buenos dias amigo [turn] [xt] mañana también",
              "[es] sí claro [en] yes sure"] * 8
    model = train_bpe(corpus, vocab_size=120,
                      user_defined_symbols=["[turn]", "[xt]", "[es]", "[en]"])
    enc, jenc = BpeEncoder(model), JBpeEncoder(model)
    texts = corpus + ["[es] hola [turn] [xt] hello", "unseen zzz ü 漢字 qq",
                      "  espacios   [turn][xt]pegados  ", ""]
    for text in texts:
        ids = enc.encode_as_ids(text)
        plain = []
        for segment, is_uds in enc._split_user_defined(normalize_text(text)):
            plain += ([enc.piece_to_id_map[segment]] if is_uds
                      else enc._bpe_segment_plain(segment))
        assert ids == plain == jenc.encode_as_ids(text), text
    assert enc.piece_to_id("[xt]") in enc.encode_as_ids("a [turn] [xt] b")


def test_concurrent_builds_into_an_empty_folder_give_one_library(tmp_path):
    """Two builds at once into an empty folder: one library and its
    compiler output, loadable, and nothing left of the temporary files."""
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build(tmp_path))
        except Exception as err:  # pragma: no cover - reported below
            errors.append(err)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert paths[0] == paths[1] == native.target(tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [paths[0].name, paths[0].with_suffix(".log").name])
    import ctypes

    lib = ctypes.CDLL(str(paths[0]))
    assert lib.stac_resample_poly_len(10, 2, 1) == 20


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    broken = tmp_path / "stacnative.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="stacnative.cpp"):
        native.build(tmp_path / "out")
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())
