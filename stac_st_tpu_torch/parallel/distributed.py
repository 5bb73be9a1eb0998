"""The row partition of a global batch across processes (port of
``process_row_block`` in ``stac_st_tpu/parallel/distributed.py``).

The loader's ``set_shard`` decodes audio only for the rows its process
owns, and a multi-process trainer must ship exactly those rows; both read
the partition from here. Process groups themselves are not ported yet.
"""

from __future__ import annotations

__all__ = ["process_row_block"]


def process_row_block(n_rows: int, row_multiple: int,
                      index: int, count: int):
    """The (lo, hi) row block process ``index`` of ``count`` owns in a
    global batch of ``n_rows`` rows, after padding the rows to a multiple
    of ``row_multiple`` (which ``count`` must divide)."""
    if row_multiple % count:
        raise ValueError(
            f"row_multiple {row_multiple} not divisible by count {count}")
    padded = -(-int(n_rows) // int(row_multiple)) * int(row_multiple)
    per = padded // int(count)
    return index * per, (index + 1) * per
