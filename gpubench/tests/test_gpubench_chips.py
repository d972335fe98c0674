"""The harness on a cell's cards, with the card's readings faked: a cell
sees the first `chips` visible cards and no other; after a build each of
them is synchronized and its cache emptied; the peak is read on each and
the fullest one's is the cell's."""

import pytest
import torch

from gpubench import harness


@pytest.mark.parametrize("chips,visible,want", [
    (1, None, "0"), (4, None, "0,1,2,3"), (1, "3,1,2", "3"), (4, "7,6,5,4,3", "7,6,5,4"),
    (4, "2,5", "2,5"), (1, "GPU-5f3a,GPU-77b0", "GPU-5f3a"), (1, "", ""),
])
def test_visible_cards(chips, visible, want):
    assert harness.visible_cards(chips, visible) == want


class FakeCards:
    """torch.cuda's per-card calls on `n` cards, each recorded."""

    def __init__(self, monkeypatch, peaks):
        self.peaks, self.calls, self.current = list(peaks), [], 0
        cards = self

        class Device:
            def __init__(self, i):
                self.i = i

            def __enter__(self):
                cards.current = self.i

            def __exit__(self, *exc):
                cards.current = 0

        monkeypatch.setattr(torch.cuda, "max_memory_allocated", self.peak)
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", self.reset)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda i: self.calls.append(("sync", i)))
        monkeypatch.setattr(torch.cuda, "empty_cache",
                            lambda: self.calls.append(("empty", self.current)))
        monkeypatch.setattr(torch.cuda, "device", Device)

    def peak(self, i):
        self.calls.append(("peak", i))
        return self.peaks[i]

    def reset(self, i):
        self.calls.append(("reset", i))
        self.peaks[i] = 0


def test_peaks_read_on_each_of_the_cells_cards(monkeypatch):
    cards = FakeCards(monkeypatch, [5 << 30, 9 << 30, 7 << 30, 1 << 30, 80 << 30])
    got = harness.card_peaks(4)
    assert got == [5 << 30, 9 << 30, 7 << 30, 1 << 30] and max(got) == 9 << 30
    assert cards.calls == [("peak", i) for i in range(4)]  # not the fifth card
    cards.calls.clear()
    assert harness.card_peaks(1) == [5 << 30]
    assert cards.calls == [("peak", 0)]
    cards.calls.clear()
    harness.reset_card_peaks(4)
    assert cards.calls == [("reset", i) for i in range(4)]
    assert harness.card_peaks(4) == [0, 0, 0, 0] and cards.peaks[4] == 80 << 30


@pytest.mark.parametrize("chips", [1, 4])
def test_each_card_settled_after_a_build(monkeypatch, chips):
    cards = FakeCards(monkeypatch, [0] * 8)
    harness.settle_cards(chips)
    assert cards.calls == [c for i in range(chips) for c in (("sync", i), ("empty", i))]
