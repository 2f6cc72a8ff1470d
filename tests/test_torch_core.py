"""``stormx_torch.core`` — config, logging, banner, profiling and the debug
modes — against the JAX package's ``stormx.core`` where both give a value,
on the CPU."""

import itertools
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stormx.core as J
import stormx_torch
import stormx_torch.core as T
from stormx_torch.core import debug
from stormx_torch.core.exceptions import SolverBreakdownError, StormError, StormIoError


@pytest.fixture
def x64_off():
    T.enable_x64(False)
    yield
    T.enable_x64(False)


class TestConfig:
    def test_x64_flag_sets_the_working_dtype(self, x64_off):
        default = torch.get_default_dtype()
        assert not T.x64_enabled() and T.default_real_dtype() == torch.float32
        T.enable_x64()
        assert T.x64_enabled() and T.default_real_dtype() == torch.float64
        # A flag of the package: torch's own default stays as it was.
        assert torch.get_default_dtype() == default
        T.enable_x64(False)
        assert T.default_real_dtype() == torch.float32

    def test_int_dtype_and_machine_epsilon(self, x64_off):
        assert T.default_int_dtype() == torch.int32
        assert str(J.default_int_dtype()) == "int32"
        assert T.machine_epsilon() == float(np.finfo(np.float32).eps)
        for t_dt, j_dt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
            assert T.machine_epsilon(t_dt) == J.machine_epsilon(j_dt)

    def test_top_level_names(self):
        assert stormx_torch.enable_x64 is T.enable_x64
        assert stormx_torch.print_banner is T.print_banner
        assert callable(stormx_torch.solve) and callable(stormx_torch.solve_non_uniform)
        assert callable(stormx_torch.make_symmetric_operator)

    def test_exports_match_the_jax_package(self):
        # but Timer, which the port's spans (core/profiling.py) replace
        assert set(J.__all__) - {"Timer"} <= set(T.__all__)
        assert "Timer" not in T.__all__


class TestExceptionsLoggingBanner:
    def test_hierarchy(self):
        assert issubclass(SolverBreakdownError, StormError)
        assert issubclass(StormIoError, StormError)
        assert SolverBreakdownError.__mro__[1].__name__ == J.SolverBreakdownError.__mro__[1].__name__

    def test_logger_is_separate_from_the_jax_package(self):
        from stormx.core.logging import TRACE as J_TRACE
        from stormx_torch.core.logging import TRACE

        log = T.get_logger()
        assert log.name == "stormx_torch"
        assert T.get_logger("solvers").name == "stormx_torch.solvers"
        assert J.get_logger().name == "stormx"
        assert not log.name.startswith(J.get_logger().name + ".")
        assert TRACE == J_TRACE == 5 and logging.getLevelName(TRACE) == "TRACE"

    def test_trace_level_records(self, caplog):
        from stormx_torch.core.logging import TRACE

        log = T.get_logger("test")
        with caplog.at_level(TRACE, logger="stormx_torch"):
            log.log(TRACE, "deep detail")
        assert [r.levelname for r in caplog.records] == ["TRACE"]

    def test_banner(self, capsys):
        from stormx.core.banner import BANNER as J_BANNER
        from stormx_torch.core.banner import BANNER

        T.print_banner()
        out = capsys.readouterr().out
        assert out == BANNER + "\n"
        # The same art as the JAX package's; only the tag line differs.
        assert BANNER.splitlines()[:-1] == J_BANNER.splitlines()[:-1]


class TestProfiling:
    def test_trace_and_annotate_write_a_trace(self, tmp_path):
        with T.trace(str(tmp_path)):
            with T.annotate("stormx-region"):
                torch.arange(8.0).sum()
        files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
        assert len(files) == 1
        with open(tmp_path / files[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "stormx-region" for e in events)


class TestChecked:
    def test_nan_from_log_of_negative(self):
        err, out = T.checked(torch.log)(torch.tensor([-1.0, 1.0]))
        assert "nan generated" in err.get() and "log" in err.get()
        assert torch.isnan(out[0])
        with pytest.raises(debug.CheckError, match="nan"):
            err.throw()

    def test_clean_case(self):
        err, out = T.checked(lambda x: torch.log(x) * 2 + x[torch.tensor([0, 1])])(
            torch.tensor([2.0, 3.0]))
        assert err.get() is None
        err.throw()
        np.testing.assert_allclose(out.numpy(), 2 * np.log([2.0, 3.0]) + [2.0, 3.0], rtol=1e-6)

    def test_nan_in_the_input_is_not_produced(self):
        err, _ = T.checked(lambda x: x * 2)(torch.tensor([float("nan")]))
        assert err.get() is None
        err, _ = T.checked(lambda: torch.full((3,), float("nan")))()
        assert err.get() is None

    @pytest.mark.parametrize("fn", [
        lambda x: x[torch.tensor([0, 5])],
        lambda x: x[torch.tensor([-4])],
        lambda x: torch.index_select(x, 0, torch.tensor([0, 3])),
        lambda x: torch.gather(x, 0, torch.tensor([-1, 1])),
        lambda x: torch.take(x, torch.tensor([7])),
        lambda x: x.clone().index_put_((torch.tensor([4]),), torch.tensor(1.0)),
    ], ids=["index", "index_negative", "index_select", "gather", "take", "index_put"])
    def test_out_of_range_index(self, fn):
        """Recorded before the op runs; the op then runs on clamped indices."""
        err, out = T.checked(fn)(torch.arange(3.0))
        assert "out-of-bounds" in err.get()
        assert torch.isfinite(out).all()

    def test_in_range_negative_index_is_fine(self):
        err, out = T.checked(lambda x: x[torch.tensor([-1, -3])])(torch.arange(3.0))
        assert err.get() is None and out.tolist() == [2.0, 0.0]

    @pytest.mark.parametrize("fn", [
        lambda a, b: a // b,
        lambda a, b: a % b,
        lambda a, b: torch.div(a, b, rounding_mode="trunc"),
        lambda a, b: torch.fmod(a, b),
        lambda a, b: a // 0,
    ], ids=["floor_divide", "remainder", "div_trunc", "fmod", "scalar"])
    def test_integer_division_by_zero(self, fn):
        err, _ = T.checked(fn)(torch.tensor([4, 5]), torch.tensor([2, 0]))
        assert "division by zero" in err.get()

    def test_float_division_is_not_an_error(self):
        err, out = T.checked(lambda a, b: a / b)(torch.tensor([1.0]), torch.tensor([0.0]))
        assert err.get() is None and torch.isinf(out).all()

    def test_first_error_is_kept_and_checks_select(self):
        def fn(x):
            return torch.log(x)[torch.tensor([9])]

        err, _ = T.checked(fn)(torch.tensor([-1.0]))
        assert "nan" in err.get()
        err, _ = T.checked(fn, errors={"index"})(torch.tensor([-1.0]))
        assert "out-of-bounds" in err.get()
        with pytest.raises(ValueError):
            T.checked(fn, errors={"bogus"})

    def test_the_jax_package_reports_the_same_nan(self):
        j_err, _ = J.checked(jnp.log)(jnp.asarray([-1.0]))
        t_err, _ = T.checked(torch.log)(torch.tensor([-1.0]))
        assert "nan generated" in j_err.get() and "nan generated" in t_err.get()


class TestNanChecks:
    def test_on_and_off(self):
        depth = torch._C._len_torch_dispatch_stack()
        T.enable_nan_checks()
        try:
            with pytest.raises(FloatingPointError, match="log"):
                torch.log(torch.tensor([-1.0]))
            assert float(torch.log(torch.tensor([1.0]))) == 0.0
        finally:
            T.enable_nan_checks(False)
        assert torch._C._len_torch_dispatch_stack() == depth
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()

    def test_enabling_twice_pushes_one_mode(self):
        depth = torch._C._len_torch_dispatch_stack()
        T.enable_nan_checks()
        T.enable_nan_checks(True)
        try:
            assert torch._C._len_torch_dispatch_stack() == depth + 1
        finally:
            T.enable_nan_checks(False)
        T.enable_nan_checks(False)
        assert torch._C._len_torch_dispatch_stack() == depth

    def test_a_solve_runs_under_the_checks(self):
        """The history's NaN padding comes from a NaN fill value, so a clean
        CG solve raises nothing."""
        from stormx_torch.solvers import SolverOptions, cg, make_operator

        a = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
        T.enable_nan_checks()
        try:
            res = cg(make_operator(lambda x: a @ x), torch.ones(2, dtype=torch.float64),
                     torch.zeros(2, dtype=torch.float64),
                     options=SolverOptions(num_iterations=10, relative_tolerance=1e-12))
        finally:
            T.enable_nan_checks(False)
        assert res.converged


class TestAssertDeterministic:
    def test_passes_on_a_deterministic_function(self):
        T.assert_deterministic(lambda x: (x * 2, {"n": 3, "nan": torch.tensor(float("nan"))}),
                               torch.arange(4.0))

    def test_fails_on_a_nondeterministic_function(self):
        count = itertools.count()
        with pytest.raises(AssertionError, match="differs"):
            T.assert_deterministic(lambda: torch.tensor([float(next(count))]))

    def test_one_bit_is_enough(self):
        vals = iter([torch.tensor([0.0]), torch.tensor([-0.0])])
        with pytest.raises(AssertionError):
            T.assert_deterministic(lambda: next(vals))

    def test_solve_result_is_opened(self):
        from stormx_torch.solvers import SolverOptions, cg, make_operator

        a = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
        T.assert_deterministic(
            lambda: cg(make_operator(lambda x: a @ x), torch.ones(2, dtype=torch.float64),
                       torch.zeros(2, dtype=torch.float64),
                       options=SolverOptions(num_iterations=10)), runs=3)
