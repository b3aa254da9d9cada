"""The frozen yardstick of kernel #1."""

import pytest

from benchmark import roofline


def test_bench_shape_bound():
    seconds, binds = roofline.pairhmm_least_seconds(65_536, 150, 8)
    assert binds == "operations"
    assert seconds * 1e3 == pytest.approx(0.11321, abs=5e-6)


def test_launches_add_up():
    launches = [(300, 150, 8), (700, 150, 16)]
    total = roofline.launches_least_seconds(launches)
    assert total == pytest.approx(sum(roofline.pairhmm_least_seconds(*x)[0]
                                      for x in launches))
    # 300 pairs of 150 rows at band 8: about half a microsecond
    assert roofline.pairhmm_least_seconds(300, 150, 8)[0] == pytest.approx(
        5.18e-7, rel=0.01)
