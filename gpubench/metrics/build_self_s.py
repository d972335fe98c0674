"""build_self_s: seconds a build spends in its root span `twopaco`
(cli/twopaco.py main) outside every child span: the root's duration less
what its children cover, from the span lines the build prints, averaged
over the traced builds."""

from gpubench.spans import ROOT_SPAN, per_build


def read(record):
    return per_build(record, lambda spans, _c: spans[ROOT_SPAN][2] if ROOT_SPAN in spans else None)
