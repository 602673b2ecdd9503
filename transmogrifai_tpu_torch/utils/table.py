"""ASCII table renderer for summaryPretty (the port's copy of
``transmogrifai_tpu/utils/table.py``; reference:
utils/src/main/scala/com/salesforce/op/utils/table/Table.scala)."""

from __future__ import annotations

from typing import List, Optional, Sequence


def render_table(headers: Sequence[str], rows: Sequence[Sequence],
                 title: Optional[str] = None) -> str:
    cells = [[str(c) for c in r] for r in rows]
    widths = [len(h) for h in headers]
    for r in cells:
        for i, c in enumerate(r):
            if i < len(widths):
                widths[i] = max(widths[i], len(c))

    def line(ch="-", junction="+"):
        return junction + junction.join(ch * (w + 2) for w in widths) + junction

    def fmt_row(vals):
        return "| " + " | ".join(
            v.ljust(w) for v, w in zip(vals, widths)) + " |"

    out = []
    if title:
        total = sum(widths) + 3 * len(widths) + 1
        out.append(line("="))
        out.append("|" + title.center(total - 2) + "|")
    out.append(line("="))
    out.append(fmt_row(list(headers)))
    out.append(line("="))
    for r in cells:
        out.append(fmt_row(r + [""] * (len(widths) - len(r))))
    out.append(line("-"))
    return "\n".join(out)
