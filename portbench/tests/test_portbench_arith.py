"""The metric arithmetic and the comparison that decides ``correct``."""

import math
from types import SimpleNamespace

import pytest

from portbench import arith, gen, reference


def test_flush_rate_counts_a_stall():
    steady = [(t * 5.0, 8192) for t in range(8)]
    assert arith.flush_rate(steady) == pytest.approx(8192 / 5.0)
    stalled = steady[:4] + [(t + 30.0, r) for t, r in steady[4:]]
    # the stall is in the time, and the first flush's rows are not
    assert arith.flush_rate(stalled) == pytest.approx(
        7 * 8192 / (35.0 + 30.0))
    with pytest.raises(ValueError):
        arith.flush_rate(steady[:1])
    # a stall inside a pass counts in the window's rate too
    opening = [(t * 5.0, (2 + t) * 128, 0) for t in range(6)]
    stalled = opening[:3] + [(t + 30.0, r, p) for t, r, p in opening[3:]]
    intervals, rate = arith.steady_window(stalled, 128, 2, 1200)
    assert [iv.rows for iv in intervals] == [128] * 5
    assert rate == pytest.approx(5 * 128 / (25.0 + 30.0))


#: the cell's sizes: Pods in a pass, rows in a chunk, warm chunks, and
#: the window's seconds
PASS, CHUNK, WARM, SECONDS = 150_000, 16_384, 2, 51.0


def _timeline(chunk_s: float, restart_s: float, passes: int = 6):
    """Chunk-opening flushes ``[(time, row, pass)]`` of a scan from the
    window's opening (pass 0's chunk ``WARM``), every chunk taking
    ``chunk_s``, the interval across each pass's end ``restart_s`` (the
    last, partial chunk and the next pass's cold fill), and the next
    pass's first chunk half as long again as the rest."""
    out, t = [], 0.0
    for p in range(passes):
        for row in range(0 if p else WARM * CHUNK, PASS, CHUNK):
            out.append((t, row, p))
            if row + CHUNK >= PASS:
                t += restart_s
            else:
                t += chunk_s * (1.5 if row == 0 else 1.0)
    return out


def _new_reading(flushes) -> float:
    """The rate as the driver reads it: flushes come in while they are
    before the window's close (``arith.close_at``)."""
    seen = flushes[:1]
    for f in flushes[1:]:
        if f[0] >= arith.close_at(seen, CHUNK, WARM, PASS, SECONDS):
            break
        seen.append(f)
    intervals, rate = arith.steady_window(seen, CHUNK, WARM, PASS)
    assert SECONDS - max(iv.end - iv.start for iv in intervals) <= \
        sum(iv.end - iv.start for iv in intervals) < SECONDS
    return rate


def _pr14_reading(flushes) -> float:
    """The rate by the first benchmark's rule: the flushes before the
    wall clock's ``SECONDS``, each credited with the rows since the last,
    a pass's end and the next pass's cold start included."""
    seen = [f for f in flushes if f[0] < SECONDS]
    rows = [0] + [r1 - r0 if p1 == p0 else PASS - r0 + r1
                  for (_, r0, p0), (_, r1, p1) in zip(seen, seen[1:])]
    return arith.flush_rate([(t, r) for (t, _, _), r in zip(seen, rows)])


@pytest.mark.parametrize('restart_s', [4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0])
def test_the_window_reads_the_chunk_rate_across_pass_ends(restart_s):
    """Over chunk rates from 1,800 to 4,000 Pods/s the window reads the
    true rate within 1 % and rises with it; the first benchmark's rule,
    which credited the interval across a pass's end, falls somewhere in
    the same sweep, where a pass's end comes into its window."""
    true = [float(r) for r in range(1800, 4001, 25)]
    new = [_new_reading(_timeline(CHUNK / r, restart_s)) for r in true]
    old = [_pr14_reading(_timeline(CHUNK / r, restart_s)) for r in true]
    for r, got in zip(true, new):
        assert got == pytest.approx(r, rel=0.01)
    assert all(b > a for a, b in zip(new, new[1:]))
    assert any(b < a for a, b in zip(old, old[1:]))
    # below the step the two rules agree
    assert old[0] == pytest.approx(new[0])


def _small_timeline():
    """Pass 0 from chunk 2, pass 1 from chunk 0 to chunk 7, 1 s a chunk,
    the pass's end 9 s and the next pass's chunks 0-1 5 s each."""
    out, t = [], 0.0
    for p, rows in ((0, range(256, 1200, 128)), (1, range(0, 1000, 128))):
        for row in rows:
            out.append((t, row, p))
            t += 9.0 if row == 1152 else 5.0 if row < 256 and p else 1.0
    return out


def test_the_window_drops_pass_ends_and_warm_chunks():
    """A window over two passes (chunks of 128, a pass of 1,200 rows, two
    warm chunks) counts chunks 2-8 of a pass: chunk 9 (48 rows, then the
    next pass's cold start) and the next pass's chunks 0-1 are dropped,
    rows and time."""
    flushes = _small_timeline()
    intervals, rate = arith.steady_window(flushes, 128, 2, 1200)
    assert [(flushes[iv.first][2], flushes[iv.first][1] // 128)
            for iv in intervals] == \
        [(0, c) for c in range(2, 9)] + [(1, c) for c in range(2, 7)]
    assert rate == pytest.approx(128 / 1.0)
    # a window of 11.5 s closes inside pass 1's chunk 6, and never
    # inside pass 0's chunk 9 or pass 1's chunks 0-1
    assert arith.close_at(flushes[:15], 128, 2, 1200, 11.5) == \
        pytest.approx(flushes[14][0] + 0.5)
    for k in (8, 9, 10):
        assert arith.close_at(flushes[:k], 128, 2, 1200, 11.5) == math.inf
    assert arith.steady_window(flushes[:1], 128, 2, 1200) == ([], None)


def test_the_stage_readers_and_the_device_read_the_counted_intervals():
    """Stage seconds, K1v's launches and the device's activity in a
    dropped interval are left out."""
    from portbench import devtime, readers
    flushes = _small_timeline()
    intervals, _ = arith.steady_window(flushes, 128, 2, 1200)
    counted = {iv.first for iv in intervals}
    snaps, total = [], 0.0
    for k in range(len(flushes)):
        snaps.append({'report': total})
        # 0.25 s of report a counted chunk, 100 s in a dropped one
        total += 0.25 if k in counted else 100.0
    obs = {'flushes': flushes, 'stages': snaps, 'intervals': intervals,
           'chunk': 128}
    assert readers.stage_ms_per_chunk(obs, ('report',)) == \
        pytest.approx(250.0)
    assert readers.stages_recorded(obs, ('report',))
    assert not readers.stages_recorded(obs, ('report', 'gc'))
    # the device: 0.1 s at each chunk opening, and 3 s in the pass's end
    activity = [(t, t + 0.1, 'k') for t, _, _ in flushes] + \
        [(flushes[7][0] + 1.0, flushes[7][0] + 4.0, 'cold')]
    spans = [(iv.start, iv.end) for iv in intervals]
    dev = devtime.clipped_activity(sorted(activity), spans)
    assert dev['window_s'] == pytest.approx(len(intervals) * 1.0)
    assert dev['busy_s'] == pytest.approx(len(intervals) * 0.1)
    assert [n for n, _ in dev['device_ops']] == ['k']
    assert all(b - a == pytest.approx(0.9) for a, b in dev['idle_gaps'])
    assert devtime.clipped_activity(activity[7:8], spans[7:]) is None
    # K1v: a launch called in each chunk, and one in the pass's end
    trace = devtime.Trace(SimpleNamespace(type='cpu'))
    trace.launches['k1_vm'] = [
        (128, _Event(0.0), _Event(2.0), t + 0.5) for t, _, _ in flushes]
    assert trace.kernel_ms('k1_vm', intervals) == \
        [(128, 2.0)] * len(intervals)


class _Event:
    """A CUDA event's stand-in: a time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_k1v_bytes_do_not_depend_on_the_pack_layout():
    import random
    from kyverno_tpu_torch import smokepack
    from kyverno_tpu_torch.compiler.encode import encode_batch
    from kyverno_tpu_torch.compiler.scan import BatchScanner
    from kyverno_tpu_torch.ops.eval import pack_batch
    from portbench import gen
    scanner = BatchScanner(smokepack.load_smoke_pack(), device='cpu')
    pods = gen.scan_pods('config4', 64, 3)
    tensors = encode_batch(pods, scanner.cps).tensors()
    lane_bytes = sum(a.nbytes for a in tensors.values()) / 64
    counts, packed_bytes = set(), set()
    for order in range(4):
        names = sorted(tensors)
        random.Random(order).shuffle(names)
        lanes = {n: tensors[n] for n in names}
        packed, _layout = pack_batch(lanes)
        packed_bytes.add(sum(v.nbytes for v in packed.values()))
        counts.add(arith.k1v_bytes(
            64, sum(a.nbytes for a in lanes.values()) / 64, 13))
    # the same lanes packed in another order are the same work
    assert counts == {64 * (lane_bytes + 13 * 6)}
    assert arith.k1v_least_s(16384, lane_bytes, 13) == pytest.approx(
        arith.k1v_bytes(16384, lane_bytes, 13) / arith.HBM_BYTES_PER_S)


def _yielded(rows_of):
    out = reference.Yielded()
    for i, (results, summary) in rows_of:
        out.add(i, results, summary)
    return out


def test_the_comparison_judges_every_recorded_pod():
    rules = reference.pack_rules(['best_practice', 'jmespath', 'pss'])
    pods = gen.scan_pods('config4', 60, 2**31 + 41)
    good = [(i, reference.report_rows(rules, p, 7))
            for i, p in enumerate(pods)]
    # the same Pod yielded twice (a second pass) is judged twice
    assert reference.rows_wrong(rules, pods, _yielded(good + good[:5]),
                                7) == 0
    row = dict(good[3][1][0][1], message='altered')
    altered = list(good)
    altered[3] = (3, ([good[3][1][0][0], row] + good[3][1][0][2:],
                      good[3][1][1]))
    assert reference.rows_wrong(rules, pods, _yielded(altered), 7) == 1
    reordered = list(good)
    reordered[9] = (9, (good[9][1][0][::-1], good[9][1][1]))
    summary = dict(good[10][1][1], skip=good[10][1][1]['skip'] + 1)
    reordered[10] = (10, (good[10][1][0], summary))
    assert reference.rows_wrong(rules, pods, _yielded(reordered), 7) == 2
    # a row's keys in another order are the same row
    shuffled = [(i, ([dict(reversed(list(r.items()))) for r in rows], s))
                for i, (rows, s) in good]
    assert reference.rows_wrong(rules, pods, _yielded(shuffled), 7) == 0
    # the row of another Pod is wrong
    swapped = [(i, good[(i + 1) % len(good)][1]) for i, _ in good]
    assert reference.rows_wrong(rules, pods, _yielded(swapped), 7) > 0
