"""The port's speaker-change metrics, RTTM alignment and scoring scripts
against the JAX package's on seeded inputs: results exactly equal (the
same floats, the same files byte for byte, the same printed lines and
JSON reports). Inputs: random ref/hyp RTTM conversations (merges, jitter,
insertions, deletions, zero gaps, overlaps, a single-label hypothesis),
random multi-turn manifests with model RTTM spikes on each utterance's
absolute clock, and per-conversation hypothesis CSVs."""

import json
import os
import sys

import numpy as np
import pytest

from stac_st_tpu.eval import rttm_fix as jrttm
from stac_st_tpu.eval import speaker_change as jsc
from stac_st_tpu_torch.eval import rttm_fix as prttm
from stac_st_tpu_torch.eval import speaker_change as psc
from stac_st_tpu_torch.evaluations.vad_shas import (
    run_eval_speaker_change as p_eval_script,
)
from stac_st_tpu_torch.evaluations.vad_shas import (
    run_inference_and_eval as p_infer_script,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "evaluations", "vad_shas"))


def _write_rttm(path, rows):
    with open(path, "w") as f:
        for name, start, dur, spk in rows:
            f.write(f"SPEAKER {name} 1 {start} {dur} <NA> <NA> {spk} "
                    f"<NA> <NA>\n")


def _conversation(rng, n, zero_gaps=False, overlaps=False):
    rows, t = [], float(rng.uniform(0.0, 2.0))
    for i in range(n):
        dur = float(rng.uniform(0.8, 4.0))
        rows.append(("conv", round(t, 3), round(dur, 3), "AB"[i % 2]))
        gap = 0.0 if zero_gaps and i % 3 == 0 else float(
            rng.uniform(0.05, 1.2))
        if overlaps and i % 4 == 1:
            gap = -float(rng.uniform(0.05, 0.4))
        t += dur + gap
    return rows


def _hypothesis(rng, ref, single_label=False):
    """Jittered, merged, dropped and inserted turns of ``ref``."""
    rows = []
    for i, (name, s, d, spk) in enumerate(ref):
        if rng.uniform() < 0.15:
            continue  # a missed turn
        s = max(0.0, s + float(rng.normal(0, 0.3)))
        rows.append((name, round(s, 3), round(d, 3),
                     "X" if single_label else
                     ("A" if rng.uniform() < 0.2 else spk)))
        if rng.uniform() < 0.2:  # a false alarm inside the turn
            rows.append((name, round(s + d / 2, 3), 0.5, "C"))
    return rows


# conversation kinds: plain, zero gaps, overlaps, both, a single-label
# hypothesis (the reference's no-aggregation path)
PAIR_KINDS = ("plain", "zero_gaps", "overlaps", "zero_gaps_overlaps",
              "single_label")


@pytest.fixture(scope="module")
def rttm_pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rttm")
    rng = np.random.default_rng(5)
    pairs = {}
    for kind in PAIR_KINDS:
        kw = {k: True for k in ("zero_gaps", "overlaps") if k in kind}
        ref = _conversation(rng, int(rng.integers(6, 16)), **kw)
        hyp = _hypothesis(rng, ref, single_label=(kind == "single_label"))
        ref_p, hyp_p = str(root / f"{kind}.ref.rttm"), str(
            root / f"{kind}.hyp.rttm")
        _write_rttm(ref_p, ref)
        _write_rttm(hyp_p, hyp)
        pairs[kind] = (ref_p, hyp_p)
    return pairs


@pytest.fixture(scope="module")
def turns_manifest(tmp_path_factory):
    """A multi-turn manifest (uid = conv-ch-start_cs-end_cs, some
    single-segment rows, some same-channel neighbours), model RTTM spikes
    on each utterance's absolute clock, and per-conversation hypothesis
    CSVs."""
    root = tmp_path_factory.mktemp("turns")
    rng = np.random.default_rng(11)
    manifest, spikes, hyp_rows = {}, [], {}
    t = 0.0
    for i in range(12):
        conv = f"conv{i % 3}"
        dur = float(rng.uniform(3.0, 12.0))
        n_seg = int(rng.integers(1, 4))
        starts = np.sort(rng.uniform(0.5, dur - 0.5, n_seg - 1))
        starts = [0.0] + [round(float(s), 3) for s in starts]
        durs = [round(float(b - a), 3) for a, b in
                zip(starts, starts[1:] + [dur])]
        chans = [int(c) for c in rng.integers(0, 2, n_seg)]
        start_cs = int(round(t * 100))
        uid = f"{conv}-A-{start_cs:06d}-{start_cs + int(dur * 100):06d}"
        manifest[uid] = {
            "wav": f"{{data_root}}/wav/{uid}.wav", "duration": round(dur, 3),
            "segments_start": " ".join(f"{s:.3f}" for s in starts),
            "segments_duration": " ".join(f"{d:.3f}" for d in durs),
            "segments_channel": " ".join(str(c) for c in chans),
            "transcription": "hola [turn] que tal" if n_seg > 1 else "hola",
            "translation_0": "hello [turn] how are you" if n_seg > 1
            else "hello",
        }
        for s in starts[1:] + [float(rng.uniform(0, dur))]:
            for j in range(int(rng.integers(1, 3))):  # frame spikes
                at = t + s + float(rng.normal(0, 0.15)) + 0.04 * j
                spikes.append(f"SPEAKER {uid} 1 {max(at, 0):.2f} 0.04 "
                              f"<NA> <NA> turn <NA> <NA>")
        hyp_rows.setdefault(conv, []).append(
            "hello how are you" if rng.uniform() < 0.5 else "hello")
        t += dur + 1.0
    man_p = root / "data-turns-st.json"
    man_p.write_text(json.dumps(manifest, indent=1))
    rttm_p = root / "RTTM_dev_turn.csv"
    rttm_p.write_text("\n".join(spikes) + "\n")
    csv_p = root / "bleu_conv-st.csv"
    csv_p.write_text("ID|GT|PRED\n" + "".join(
        f"{c}|ref|{' [turn] '.join(h)}\n" for c, h in hyp_rows.items()))
    return dict(root=root, manifest=str(man_p), rttm=str(rttm_p),
                csv=str(csv_p))


@pytest.mark.parametrize("kind", PAIR_KINDS)
def test_turn_detection_equals_jax(rttm_pairs, kind):
    ref, hyp = rttm_pairs[kind]
    for merge in (True, False):
        for mean in (False, True):
            kw = dict(merge_overlap_gt_regions=merge, mean_turn_point=mean)
            want = jsc.evaluate_speaker_turn_detection(ref, hyp, **kw)
            got = psc.evaluate_speaker_turn_detection(ref, hyp, **kw)
            assert got == want
    assert psc.TOLERANCE_GRID == jsc.TOLERANCE_GRID


def test_change_points_and_rttm_alignment_equal_jax(turns_manifest,
                                                    tmp_path):
    m = turns_manifest
    gt, hyp = (psc.gt_changes_from_manifest(m["manifest"]),
               psc.hyp_changes_from_rttm(m["rttm"]))
    assert gt == jsc.gt_changes_from_manifest(m["manifest"])
    assert hyp == jsc.hyp_changes_from_rttm(m["rttm"])
    for merge_gap in (0.0, 0.5):
        assert psc.hyp_changes_from_rttm(m["rttm"], False, merge_gap) == \
            jsc.hyp_changes_from_rttm(m["rttm"], False, merge_gap)
    got = [x.as_dict() for x in psc.evaluate_speaker_change(gt, hyp)]
    want = [x.as_dict() for x in jsc.evaluate_speaker_change(gt, hyp)]
    assert got == want and any(d["TP"] for d in got)
    rng = np.random.default_rng(3)
    for _ in range(20):
        ref = list(rng.uniform(0, 20, int(rng.integers(0, 8))))
        hyp_pts = list(rng.uniform(0, 20, int(rng.integers(0, 8))))
        tol = float(rng.choice(psc.TOLERANCE_GRID))
        assert psc.score_change_points(ref, hyp_pts, tol).as_dict() == \
            jsc.score_change_points(ref, hyp_pts, tol).as_dict()

    # the aligned ref/hyp RTTM and the reference fixer on the same files
    for spacer in (5.0, 2.5):
        assert prttm.build_aligned_rttm(m["manifest"], hyp, spacer) == \
            jrttm.build_aligned_rttm(m["manifest"], hyp, spacer)
    assert prttm._utt_bounds("conv1-A-000120-000480") == \
        jrttm._utt_bounds("conv1-A-000120-000480") == (1.2, 4.8)
    assert prttm._utt_bounds("noparts") == jrttm._utt_bounds("noparts")
    for relative in (True, False):
        outs = []
        for name, mod in (("jax", jrttm), ("port", prttm)):
            d = tmp_path / f"{name}{relative}"
            d.mkdir()
            paths = mod.fix_rttm(m["manifest"], m["rttm"], str(d),
                                 relative_from_uid=relative)
            outs.append([open(p, "rb").read() for p in paths])
        assert outs[0] == outs[1] and all(outs[0])


def test_speaker_change_script_writes_jax_report(turns_manifest, rttm_pairs,
                                                 tmp_path, monkeypatch,
                                                 capsys):
    import run_eval_speaker_change as jax_script

    m = turns_manifest
    ref, hyp = rttm_pairs["zero_gaps"]
    for mode in (["--manifest", m["manifest"], "--rttm", m["rttm"]],
                 ["--ref-rttm", ref, "--rttm", hyp],
                 ["--ref-rttm", ref, "--rttm", hyp, "--no-merge-gt",
                  "--mean-turn-point", "--tolerances", "0.25", "1.0"]):
        reports = []
        for name in ("jax", "port"):
            out = str(tmp_path / f"{name}.json")
            if name == "jax":
                monkeypatch.setattr(sys, "argv", ["x", *mode, "--out", out])
                jax_script.main()
            else:
                p_eval_script.main([*mode, "--out", out])
            printed = capsys.readouterr().out
            reports.append((open(out).read(), printed))
        assert reports[0] == reports[1] and reports[0][1]


def test_inference_and_eval_script_prints_jax_scores(turns_manifest,
                                                     monkeypatch, capsys):
    import run_inference_and_eval as jax_script

    m = turns_manifest
    for extra in (["--metric", "bleu", "--rttm", m["rttm"]],
                  ["--metric", "wer"]):
        argv = ["--hyp-csv", m["csv"], "--ref-manifest", m["manifest"],
                *extra]
        monkeypatch.setattr(sys, "argv", ["x", *argv])
        jax_script.main()
        want = capsys.readouterr().out
        p_infer_script.main(argv)
        got = capsys.readouterr().out
        assert got == want and want
