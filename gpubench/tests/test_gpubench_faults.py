"""The harness's comparison catches a broken timed path: a run on the CPU
(the program's plain versions, the card's checks skipped) with a fault
planted under the program's entry comes out not correct. One cell has
one card, so there is no exchange between chips to leave out."""

import numpy as np
import pytest

from gpubench.tests import cells
from twopaco_tpu_torch.io import junctions
from twopaco_tpu_torch.passes import sortpipe


@pytest.fixture
def tiny(tmp_path):
    return cells.make_root(tmp_path)


def test_sound_run_is_correct(tiny):
    rc, result, err = cells.run_cpu(*tiny, trace=True)
    assert rc == 0 and result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert result["compared"]["records_differing"] == {"value": 0, "limit": 0}
    assert err.strip().splitlines()[-2:] == [
        "compared records_differing 0 limit 0", "compared window_builds_differing 0 limit 0"]


def test_sort_returning_its_input_unchanged(tiny, monkeypatch):
    ops = sortpipe.KERNELS
    fake = type(ops)(**{**ops.__dict__, "sort": lambda w, p, q, key_bits: (w, p, q)})
    monkeypatch.setattr(sortpipe, "KERNELS", fake)
    rc, result, _ = cells.run_cpu(*tiny)
    assert rc == 0 and result["correct"] is False
    assert result["compared"]["records_differing"]["value"] > 0


def _patch_writer(monkeypatch, change, from_call=0):
    """ChunkWriter.write with its (chrs, pos, ids) changed by `change`,
    from the from_call-th build's writer on."""
    real_init, real_write = junctions.ChunkWriter.__init__, junctions.ChunkWriter.write
    builds = [0]

    def init(self, path):
        real_init(self, path)
        self.faulty = builds[0] >= from_call
        builds[0] += 1

    def write(self, chrs, pos, ids):
        if self.faulty:
            chrs, pos, ids = change(np.asarray(chrs), np.asarray(pos), np.array(ids))
        return real_write(self, chrs, pos, ids)

    monkeypatch.setattr(junctions.ChunkWriter, "__init__", init)
    monkeypatch.setattr(junctions.ChunkWriter, "write", write)


def _drop_half(chrs, pos, ids):
    return chrs[::2], pos[::2], ids[::2]


def _alter_one(chrs, pos, ids):
    ids[len(ids) // 2] += 1
    return chrs, pos, ids


@pytest.mark.parametrize("change", [_drop_half, _alter_one], ids=["half_left_out", "one_altered"])
def test_output_fault_in_every_build(tiny, monkeypatch, change):
    _patch_writer(monkeypatch, change)
    rc, result, _ = cells.run_cpu(*tiny)
    assert rc == 0 and result["correct"] is False
    assert result["compared"]["records_differing"]["value"] > 0


def test_fault_in_the_window_only(tiny, monkeypatch):
    # the checked build is sound, a later one alters an answer
    _patch_writer(monkeypatch, _alter_one, from_call=1)
    rc, result, _ = cells.run_cpu(*tiny, seconds=0.5)
    assert rc == 0 and result["correct"] is False
    assert result["compared"]["records_differing"]["value"] == 0
    assert result["compared"]["window_builds_differing"]["value"] >= 1
    assert result["failed"] >= 1


def test_build_that_never_writes(tiny, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(sortpipe, "merge_fetched", boom)
    rc, result, err = cells.run_cpu(*tiny)
    assert rc == 0 and result["correct"] is False and result["failed"] >= 1
    assert "planted" in err


def test_no_card_no_result(tiny, capsys):
    import io

    from gpubench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(tiny[1], 1, 1.0, False, device="cuda", root=tiny[0], out=out, err=err)
    assert rc != 0 and out.getvalue() == "" and "CUDA" in err.getvalue()
