"""The port's `utils/timing.time_fn` and `PhaseTimer` against the JAX
package's (mpm_tpu/utils/timing.py:30-46, 94-115): the calls `time_fn`
makes (count and the chaining of each call's first argument), what it
returns, and `PhaseTimer`'s totals, counts and report lines; the port's
`fence` on each kind of result it is handed; and utils/profile_substep.py's
phases and report on the CPU."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpm_tpu.utils import timing as jtiming
from mpm_tpu_torch.core.state import Grid
from mpm_tpu_torch.models.scenes import dam_break_2d
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.utils import timing


def _counting(make):
    """fn(x, step) -> x + step, recording each call's arguments."""
    calls = []

    def fn(x, step):
        calls.append((float(np.asarray(x)), step))
        return x + make(step)

    return fn, calls


@pytest.mark.parametrize("iters,warmup", [(100, 3), (5, 0), (7, 2)])
def test_time_fn_calls_and_chains_as_jax(iters, warmup):
    jfn, jcalls = _counting(lambda s: jnp.float32(s))
    tfn, tcalls = _counting(lambda s: torch.tensor(s, dtype=torch.float32))
    jdt, jout = jtiming.time_fn(jfn, jnp.float32(1.0), 0.5, iters=iters, warmup=warmup)
    tdt, tout = timing.time_fn(tfn, torch.tensor(1.0), 0.5, iters=iters, warmup=warmup)
    assert tcalls == jcalls and len(tcalls) == iters + warmup
    assert float(tout) == float(jout) == 1.0 + 0.5 * (iters + warmup)
    assert tdt > 0 and jdt > 0


def test_phase_timer_as_jax():
    jpt, tpt = jtiming.PhaseTimer(), timing.PhaseTimer()
    for name, n in (("p2g", 3), ("g2p", 1), ("migrate", 2)):
        for i in range(n):
            assert float(jpt.measure(name, lambda a, b: a * b, jnp.float32(i), 2.0)) == \
                float(tpt.measure(name, lambda a, b: a * b, torch.tensor(float(i)), 2.0))
    assert dict(tpt.counts) == dict(jpt.counts) == {"p2g": 3, "g2p": 1, "migrate": 2}
    assert list(tpt.totals) == list(jpt.totals)
    assert all(v > 0 for v in tpt.totals.values())
    line = re.compile(r"^(\w+): \d+\.\d{3} ms/call x(\d+)$")
    for got in tpt.report().splitlines():
        m = line.match(got)
        assert m and int(m.group(2)) == tpt.counts[m.group(1)]
    for pt in (jpt, tpt):  # the same totals give the same report
        pt.totals.update(p2g=0.012345, g2p=0.0, migrate=1.5)
    assert tpt.report() == jpt.report()
    assert tpt.report().splitlines()[0] == "p2g: 4.115 ms/call x3"


def test_fence_takes_every_result():
    sc = dam_break_2d(device="cpu")
    state = bucketed.from_simstate(sc.state, sc.config)
    grid = Grid(mom=torch.zeros(2, 4), mass=torch.zeros(4))
    for x in (state, grid, (grid.mom, grid.mass), [state], torch.ones(3), 3, None):
        timing.fence(x)
    assert timing._first_tensor(state) is state.pos
    assert timing._first_tensor(grid) is grid.mom
    assert timing._first_tensor((1, [grid.mass])) is grid.mass
    assert timing._first_tensor(3) is None


def test_profile_substep_reports_every_phase_on_the_cpu():
    """utils/profile_substep.py's phases through PhaseTimer on a small
    benchmark pool on the CPU (its wrappers taking their plain versions): a
    report line a phase and the phase sum beside the full substep. The tool
    itself needs a card."""
    from mpm_tpu_torch.models.scenes import benchmark_scene
    from mpm_tpu_torch.utils import profile_substep

    sc = benchmark_scene(3000, device="cpu")
    state = bucketed.from_simstate(sc.state, sc.config)
    pt = timing.PhaseTimer()
    end = profile_substep.time_phases(state, sc.config, sc.fluid, pt, iters=2)
    assert int(end.lost) == 0 and bool(torch.isfinite(end.pos).all())
    report = pt.report()
    for phase in ("FULL substep", "P (p2g_update)", "F (g2p_migrate)", *profile_substep.PER_PASS):
        assert re.search(rf"^{re.escape(phase)}: \d+\.\d{{3}} ms/call x2$", report, re.M), phase
    assert re.fullmatch(r"# phase sum [\d.]+ ms \(per-pass, float32 vel/C\) vs full substep "
                        r"[\d.]+ ms; P \+ F [\d.]+ ms", profile_substep.phase_sum(pt))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device visible"):
            profile_substep.main([])
