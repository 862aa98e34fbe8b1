"""The frozen counts give the bounds of PERF.md's kernel table."""

import pytest

import roofline


def test_m1_bound_at_p4_e4096():
    seconds, by = roofline.bound_s(*roofline.m1_work(4096, 4, 64))
    assert by == "bytes" and seconds * 1e3 == pytest.approx(0.0188, abs=5e-5)


def test_m1_bound_at_p8_e4096():
    seconds, by = roofline.bound_s(*roofline.m1_work(4096, 8, 144))
    assert by == "bytes" and seconds * 1e3 == pytest.approx(0.2099, abs=5e-5)


def test_inverse_bound_at_n208_e4096():
    n = roofline.form_dofs(2, 8) + roofline.form_dofs(1, 8)
    seconds, by = roofline.bound_s(*roofline.inverse_work(4096, n))
    assert n == 208 and by == "operations" and seconds * 1e3 == pytest.approx(1.1003, abs=5e-5)


def test_navier_stokes_blocks_at_p5():
    assert sum(roofline.form_dofs(k, 5) for k in (0, 1, 2)) == 121
