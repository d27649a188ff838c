"""The generators are pure functions of the seed."""

import numpy as np

from portbench import gen


def test_scan_pods_repeat_per_seed():
    a = gen.scan_pods('config4', 300, 2**31 + 7)
    assert a == gen.scan_pods('config4', 300, 2**31 + 7)
    assert a != gen.scan_pods('config4', 300, 2**31 + 8)
    # a seed past 32 bits
    assert gen.scan_pods('config4', 50, 2**40 + 3) == \
        gen.scan_pods('config4', 50, 2**40 + 3)


def test_budgets_tell_float32_from_float64():
    over = [b for b in gen.BUDGETS if float(b) > 16]
    assert any(np.float32(float(b)) <= np.float32(16) for b in over)
    pods = gen.scan_pods('config4', 2000, 1)
    seen = {(p['metadata'].get('annotations') or {}).get('budget.io/max-cpu')
            for p in pods}
    assert set(gen.BUDGETS) <= seen
