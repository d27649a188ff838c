"""The metric arithmetic and the comparison that decides ``correct``."""

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
