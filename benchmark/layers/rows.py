"""The rows of each described grid: the map's and each component's
decoy's descriptor rows against the reference's (``rows_differ``: of
their union, the share on one side only or unequal,
:func:`plainref.judge.compare_rows`)."""

from plainref import judge

NUMBERS = ("rows_differ",)
PARTS = ("rows",)


def _rows(d) -> dict:
    return dict(octave=d.octave, subv=d.subv, main=d.main, sec=d.sec,
                desc=d.desc)


def control(ref, out):
    out["map_set"] = _rows(ref.described_map(ref.LOW))
    for i, comp in enumerate(out["components"]):
        comp["sub_set"] = _rows(ref.described_decoy(i, ref.LOW))


def compare(ref, c):
    rows = [dict(judge.compare_rows(c["map_set"], ref.described_map()),
                 part="map_set")]
    for i, comp in enumerate(c["components"]):
        rows.append(dict(judge.compare_rows(comp["sub_set"],
                                            ref.described_decoy(i)),
                         part="sub_set"))
    return {"rows": rows}


def fold(parts):
    return {"rows_differ": judge.share_differ(parts["rows"])}
