"""The whole run, past the look for a card, on the CPU at a tiny size: the
sound program comes out correct, and each fault a render cell can have,
planted under the timed path, comes out not correct. (A renderer has no
exchange between chips: its cells take one.)"""

import pytest
import torch

from cellbench import harness

CELLS = ("pcml800k.circle12", "splat800k.orbit16")


def _run(tiny, manifest, cell, wrap=None):
    return harness.run(cell, 2**31 + 11, 0.3, False, device="cpu",
                       root=tiny, manifest=manifest, wrap=wrap)


def stale(call):
    """A step that returns its state unchanged: every request after the
    first gets the first request's images."""
    first = {}

    def f(poses, timing):
        if not first:
            first.update(call(poses, timing))
        return first
    return f


def half_batch(call):
    """Half of the views left out: the first half is rendered and stands
    in for the rest."""
    def f(poses, timing):
        half = poses.shape[0] // 2
        out = call(poses[:half], timing)
        return {k: (None if v is None else
                    torch.cat([v, v[:, :poses.shape[0] - half]], 1))
                for k, v in out.items()}
    return f


def altered(call):
    """An answer altered where it is produced: the last view's colours
    come out inverted."""
    def f(poses, timing):
        out = call(poses, timing)
        out["rgb"][0, -1] = 1.0 - out["rgb"][0, -1]
        return out
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(tiny, manifest, cell):
    r = _run(tiny, manifest, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["views_missing"]["value"] == 0


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny, manifest, cell, fault):
    r = _run(tiny, manifest, cell, wrap=fault)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
