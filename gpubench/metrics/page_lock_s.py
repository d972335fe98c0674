"""page_lock_s: seconds a build spends page-locking host buffers for its
copies and unlocking them (hostmem.pinned: the `pin.lock` and
`pin.unlock` spans, cudaHostRegister and cudaHostUnregister; the upload's
staged codes, the fetch's buffers, the merge's entries), from the span
lines the build prints, averaged over the traced builds."""

from gpubench.spans import per_build


def read(record):
    return per_build(record, lambda spans, _c: sum(
        spans.get(name, (0, 0.0, 0.0))[1] for name in ("pin.lock", "pin.unlock")))
