"""LDC transcript parsers: Fisher ``.tdf`` and CALLHOME text formats (port of
``stac_st_tpu/prep/tdf.py``).

Fisher Spanish (LDC2010T04) ships tab-delimited ``.tdf`` transcripts: three
header lines, then rows ``file  channel  start  end  speaker  speakerType
speakerDialect  transcript  section  turn  utt ...`` (reference
``fisher_callhome_prepare.py:293-322``). CALLHOME Spanish (LDC96T17) ships
ISO-8859-1 text transcripts with ``start end speaker: text`` lines
(``callhome_prepare.py:260-300``).

Times are converted to centiseconds (the uid/time convention of the whole
pipeline).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional

__all__ = ["Segment", "parse_tdf", "parse_callhome"]


@dataclass
class Segment:
    channel: int
    start: int      # centiseconds
    end: int        # centiseconds
    transcript: str
    speaker: str = ""


def parse_tdf(path: str, clean: Optional[Callable[[str], str]] = None,
              n_header_lines: int = 3) -> List[Segment]:
    """Parse one Fisher .tdf transcript file."""
    segments: List[Segment] = []
    with open(path, encoding="utf-8", errors="replace") as f:
        for i, line in enumerate(f):
            if i < n_header_lines:
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 8:
                continue
            try:
                channel = int(fields[1])
                start = int(float(fields[2]) * 100)
                end = int(float(fields[3]) * 100)
            except ValueError:
                continue
            text = fields[7]
            if clean is not None:
                text = clean(text)
            segments.append(Segment(
                channel=channel, start=start, end=end, transcript=text,
                speaker=fields[4] if len(fields) > 4 else "",
            ))
    return segments


_CALLHOME_LINE = re.compile(
    r"^\s*(?P<start>\d+(?:\.\d+)?)\s+(?P<end>\d+(?:\.\d+)?)\s+"
    r"(?P<speaker>[AB]\d*):\s*(?P<text>.*)$"
)


def parse_callhome(path: str, clean: Optional[Callable[[str], str]] = None,
                   encoding: str = "ISO-8859-1") -> List[Segment]:
    """Parse one CALLHOME Spanish transcript (``.txt``)."""
    segments: List[Segment] = []
    with open(path, encoding=encoding, errors="replace") as f:
        for line in f:
            m = _CALLHOME_LINE.match(line)
            if not m:
                continue
            speaker = m.group("speaker")
            channel = 0 if speaker.startswith("A") else 1
            text = m.group("text")
            if clean is not None:
                text = clean(text)
            segments.append(Segment(
                channel=channel,
                start=int(float(m.group("start")) * 100),
                end=int(float(m.group("end")) * 100),
                transcript=text,
                speaker=speaker,
            ))
    return segments
