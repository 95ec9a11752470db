"""The port's copy of the slot scheduler against the JAX package's.

Each case drives both ``SlotScheduler``s through the same sequence of
calls (submit, admit, release, preempt, cancel, expire, on one virtual
clock each) and compares what they report at every step: admission
order and slots, recycled slots, priorities, preemption victims and the
request states. The length policy is the port's copy in both, warmed
with the same observations (the scheduler only reads
``expected_length``)."""

import pytest

from repro.core import scheduler as J
from repro.fault.clock import VirtualClock as JVirtualClock
from repro_torch.core import scheduler as T
from repro_torch.core.length_policy import LengthPolicy
from repro_torch.fault.clock import VirtualClock


def _warmed_policy():
    lp = LengthPolicy()
    for _ in range(5):
        for pid, L in [("s", 5.0), ("m", 20.0), ("l", 80.0)]:
            lp.observe(pid, L)
    return lp


def _view(reqs):
    return [(r.rid, r.slot, r.state, r.n_preempted) for r in reqs]


def _admission_order(mod, clock_cls):
    sched = mod.SlotScheduler(2, _warmed_policy(), clock=clock_cls())
    reqs = [mod.Request(rid=i, problem_id=pid)
            for i, pid in enumerate(["s", "m", "l", "s", "l"])]
    for r in reqs:
        sched.submit(r)
    log = [_view(sched.next_admissions()), _view(sched.next_admissions()),
           (sched.n_queued, sched.n_running)]
    return log


def _recycling(mod, clock_cls):
    sched = mod.SlotScheduler(2, _warmed_policy(), clock=clock_cls())
    reqs = [mod.Request(rid=i, problem_id=pid)
            for i, pid in enumerate(["s", "m", "l", "s"])]
    for r in reqs:
        sched.submit(r)
    first = sched.next_admissions()
    log = [_view(first), sched.release(first[0])]
    nxt = sched.next_admissions()
    log.append(_view(nxt))
    sched.release(first[1])
    sched.release(nxt[0])
    last = sched.next_admissions()
    log.append(_view(last))
    for r in last:
        log.append(sched.release(r))
    log.append((sched.has_work(), sched.n_finished, _view(reqs)))
    return log


def _priority_fallbacks(mod, clock_cls):
    sched = mod.SlotScheduler(1, clock=clock_cls())  # no length policy
    reqs = [mod.Request(rid=0, max_new_tokens=8),
            mod.Request(rid=1, max_new_tokens=64),
            mod.Request(rid=2, max_new_tokens=16, predicted_len=1000.0)]
    for r in reqs:
        sched.submit(r)
    order = []
    while sched.has_work():
        got = sched.next_admissions()[0]
        order.append((got.rid, sched.priority(got)))
        sched.release(got)
    return order


def _preemption(mod, clock_cls):
    clk = clock_cls()
    sched = mod.SlotScheduler(2, _warmed_policy(), clock=clk)
    res = [mod.Request(rid=i, problem_id=pid, prompt=[1],
                       max_new_tokens=32)
           for i, pid in enumerate(["l", "m"])]
    for r in res:
        sched.submit(r)
    sched.next_admissions()
    for r in res:
        r.admit_round = 0
    res[0].output.extend([5, 6, 7])
    pol = mod.PreemptionPolicy(max_resident_rounds=4)
    log = [_view(sched.preemption_victims(pol, round_no=10))]  # no waiters
    w = mod.Request(rid=9, problem_id="s", prompt=[2], max_new_tokens=8,
                    deadline_s=3.0)
    sched.submit(w)
    victims = sched.preemption_victims(pol, round_no=10)
    log.append(_view(victims))
    log.append([sched.remaining_len(r) for r in res])
    # deadline margin: the waiter's deadline is near, evict the straggler
    pol2 = mod.PreemptionPolicy(deadline_margin_s=5.0)
    log.append(_view(sched.preemption_victims(pol2, round_no=1)))
    v = victims[0]
    log.append(sched.preempt(v))
    v.resume_tokens = list(v.output)
    v.predicted_len = sched.remaining_len(v)
    sched.submit(v)
    log.append(_view(sched.next_admissions()))
    # the deadline passes on the virtual clock
    clk.advance(4.0)
    due = sched.due_requests()
    log.append(_view(due))
    for r in due:
        sched.expire(r)
    log.append((sched.n_preempted, sched.n_expired, _view(res + [w])))
    return log


def _cancel_expire(mod, clock_cls):
    clk = clock_cls()
    sched = mod.SlotScheduler(1, clock=clk)
    a = mod.Request(rid=0, prompt=[1])
    b = mod.Request(rid=1, prompt=[2], deadline_s=5.0)
    sched.submit(a)
    sched.submit(b)
    (ra,) = sched.next_admissions()
    ra.output.extend([7, 8])
    sched.cancel(ra)
    log = [_view([a, b]), _view(sched.due_requests())]
    clk.advance(6.0)
    log.append(_view(sched.due_requests()))
    sched.expire(b)
    log.append((sched.n_cancelled, sched.n_expired, a.output,
                _view(sched.next_admissions()), sched.has_work()))
    with pytest.raises(mod.SchedulerStateError):
        sched.release(a)
    return log


@pytest.mark.parametrize("case", [_admission_order, _recycling,
                                  _priority_fallbacks, _preemption,
                                  _cancel_expire],
                         ids=lambda f: f.__name__.strip("_"))
def test_scheduler_equals_jax(case):
    assert case(T, VirtualClock) == case(J, JVirtualClock)

