"""Multi-turn utterance construction: greedy merge with [turn]/[xt] markers
(port of ``stac_st_tpu/prep/turns.py``).

Re-owns the reference's turn-concatenation algorithm
(``fisher_callhome_prepare_turns.py:368-485``), the data mechanism behind
speaker-turn supervision:

* stream utterances of one recording in start-time order;
* greedily merge into windows of at most ``max_seconds``;
* a merge is rejected when segments are mis-ordered (start₂ ≤ start₁) or the
  second ends more than ``max_overlap`` (4 s) before the first;
* on a channel change insert `` [turn] `` — or `` [turn] [xt] `` when the
  cross-talk overlap ``end₁ − start₂`` exceeds 0.25 s — and record the
  segment's start/duration/channel metadata;
* same-channel continuations join with a space and extend the last segment.

Times are centiseconds end-to-end (the LDC convention the uids encode).
"""

from __future__ import annotations

from typing import List

from .records import Utterance

__all__ = ["concatenate_turns", "MAX_OVERLAP_ALLOWED", "XT_THRESHOLD"]

MAX_OVERLAP_ALLOWED = 4.0   # seconds; reject merges overlapping more
XT_THRESHOLD = 0.25         # seconds of cross-talk that earns [xt]


def _try_merge(a: Utterance, b: Utterance, max_overlap: float,
               xt_threshold: float) -> Utterance | None:
    if a.recording_id != b.recording_id:
        return None
    if not a.start < b.start:
        return None
    if (b.end - a.end) / 100.0 < -max_overlap:
        return None

    channels = list(a.turn_channel) or [a.channel]
    starts = list(a.turn_start) or [0.0]
    durations = list(a.turn_duration) or [(a.end - a.start) / 100.0]

    if channels[-1] != b.channel:
        overlap = (a.end - b.start) / 100.0
        joiner = " [turn] [xt] " if overlap > xt_threshold else " [turn] "
        starts.append((b.start - a.start) / 100.0)
        durations.append((b.end - b.start) / 100.0)
        channels.append(b.channel)
    else:
        joiner = " "
        # extend the running segment to cover the continuation
        durations[-1] = (b.end - (a.start + starts[-1] * 100.0)) / 100.0

    translations = [
        f"{ta}{joiner}{tb}"
        for ta, tb in zip(a.translations, b.translations)
    ]
    rec = a.recording_id
    return Utterance(
        uid=f"{rec}-0-{a.start:06d}-{b.end:06d}",
        wav=a.wav,
        duration=(b.end - a.start) / 100.0,
        transcription=f"{a.transcription}{joiner}{b.transcription}",
        translations=translations,
        source_lang=a.source_lang,
        target_lang=a.target_lang,
        source_audio=a.source_audio,
        channel=0,
        start=a.start,
        end=b.end,
        turn_start=starts,
        turn_duration=durations,
        turn_channel=channels,
    )


def concatenate_turns(
    utterances: List[Utterance],
    max_seconds: float,
    max_overlap: float = MAX_OVERLAP_ALLOWED,
    xt_threshold: float = XT_THRESHOLD,
) -> List[Utterance]:
    """Greedy left-to-right merge into ≤ max_seconds multi-turn windows."""
    if not utterances:
        return []
    out: List[Utterance] = []
    for sample in utterances:
        # channels merge into a single virtual channel 0 in uids
        if not out or out[-1].recording_id != sample.recording_id:
            out.append(_seed(sample))
            continue
        current = out[-1]
        if current.duration + sample.duration <= max_seconds:
            merged = _try_merge(current, sample, max_overlap, xt_threshold)
            if merged is not None:
                out[-1] = merged
                continue
        out.append(_seed(sample))
    return out


def _seed(utt: Utterance) -> Utterance:
    """Start a fresh window carrying per-segment metadata."""
    seeded = Utterance(
        uid=f"{utt.recording_id}-0-{utt.start:06d}-{utt.end:06d}",
        wav=utt.wav,
        duration=utt.duration,
        transcription=utt.transcription,
        translations=list(utt.translations),
        source_lang=utt.source_lang,
        target_lang=utt.target_lang,
        source_audio=utt.source_audio,
        channel=0,
        start=utt.start,
        end=utt.end,
        turn_start=[0.0],
        turn_duration=[(utt.end - utt.start) / 100.0],
        turn_channel=[utt.channel],
    )
    return seeded
