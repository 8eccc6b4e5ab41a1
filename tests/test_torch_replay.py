"""``tests/torch_vs_jax_accuracy.py --replay``: the port's system on the JAX
run's random draws, patched where the system calls them
(``slam.system.draw_track_pixels``, ``draw_pixels``,
``draw_mapping_pixels``). One seed, 4 frames of the tripwire world: every
JAX draw is used and every kind matches (the replay raises otherwise), the
first mapping pass starts from the same loss, and the two packages'
per-frame position errors agree within ``RAW_BOUND_CM``.

The bound, measured on the CPU with the replay (seeds 0-5, 4 frames): the
largest per-frame difference of position error was 3.76 cm (seed 2, frame
3), seed 0's 1.32 cm (frame 2); the packages agree in arithmetic only, and
GN tracking on a 48x64 world turns the mapping passes' rounding into
centimetres. 5 cm keeps a margin of 1.3x over the largest and 3.8x over
seed 0's; draws that did not match would give the first pass another loss.
The first loss agreed to 7.8e-8 relative (seed 0)."""
import numpy as np
import pytest
import torch
import torch_vs_jax_accuracy as acc

from niceslam_tpu_torch.core.rays import Intrinsics

torch.set_num_threads(1)

RAW_BOUND_CM = 5.0
FIRST_LOSS_RTOL = 1e-5


def map_events(records):
    return [r for r in records if r.get("event") == "map"]


def test_replay_uses_every_jax_draw_on_the_same_passes():
    runs = acc.run_seed(0, 4, replay=True, log=False)
    (jres, jslam), (tres, tslam) = runs["jax"], runs[acc.torch_name(replay=True)]
    jmap, tmap = map_events(jslam.log.records), map_events(tslam.events)
    assert [(e["frame"], e["coarse"]) for e in tmap] == [(e["frame"], e["coarse"]) for e in jmap]
    assert len(tmap) == 4  # frame 0's first pass and one pass a frame after it
    np.testing.assert_allclose(tmap[0]["loss_first"], jmap[0]["loss_first"],
                               rtol=FIRST_LOSS_RTOL)
    diff = np.abs(acc.raw_errors_cm(tres) - acc.raw_errors_cm(jres))
    assert diff.max() <= RAW_BOUND_CM, diff


class _Recorder(acc.DrawRecorder):
    """A recorder over a queue given by hand (no JAX run)."""

    def __init__(self, queue):
        import jax

        self.jax, self.queue, self._undo, self._paused = jax, list(queue), [], 0


def test_a_draw_of_another_kind_raises():
    rec = _Recorder([("overlap", np.zeros(2, np.uint32))])
    with pytest.raises(AssertionError, match="draws for track where JAX drew for overlap"):
        rec._pop("track")
    with pytest.raises(AssertionError, match="drew no more"):
        rec._pop("map")


def test_a_pass_that_parts_from_the_jax_chunks_raises():
    """A port pass must start at a JAX pass's first chunk (iteration 0),
    and its later rows must continue a chunk: otherwise the counts differ
    and the replay raises rather than pad."""
    valid = np.array([True, True, False])
    chunk = lambda start: ("map", np.zeros(2, np.uint32), np.arange(start, start + 3),  # noqa: E731
                           np.ones(3, bool), valid)
    intr = Intrinsics(H=8, W=8, fx=8.0, fy=8.0, cx=4.0, cy=4.0)
    rec = _Recorder([chunk(3)])
    with pytest.raises(AssertionError, match="pass starts"):
        rec.mapping_rows(np.array([0, 1]), 4, intr, first=True)
    rec = _Recorder([chunk(0)])
    with pytest.raises(AssertionError, match="row continues"):
        rec.mapping_rows(np.array([0, 1]), 4, intr, first=False)
    rec = _Recorder([chunk(0)])
    with pytest.raises(AssertionError, match="window differs"):
        rec.mapping_rows(np.array([0, 2]), 4, intr, first=True)
