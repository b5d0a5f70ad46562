"""The port's admission scheduler (``repro_torch.serve.scheduler``) against
the JAX package's (``repro.serve.scheduler``): the pure units of
``tests/test_scheduler.py`` run on both, and seeded operation sequences
drive both side by side; every choice must be the same."""

import numpy as np
import pytest

from repro.serve.loop import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.serve.loop import Request
from repro_torch.serve.scheduler import Scheduler

BOTH = [(Scheduler, Request), (JScheduler, JRequest)]


@pytest.mark.parametrize("S,R", BOTH, ids=["port", "jax"])
def test_scheduler_fifo_within_priority(S, R):
    s = S(aging=0)
    a = s.push(R(rid=0, prompt=np.ones(4, np.int32)))
    b = s.push(R(rid=1, prompt=np.ones(4, np.int32)))
    assert s.peek() is a
    s.pop(a)
    assert s.peek() is b


@pytest.mark.parametrize("S,R", BOTH, ids=["port", "jax"])
def test_scheduler_aging_prevents_starvation(S, R):
    """A low-priority entry waiting long enough overtakes a fresh
    high-priority one: aging bounds every request's wait."""
    s = S(aging=4)
    lo = s.push(R(rid=0, prompt=np.ones(4, np.int32)), priority=0)
    for _ in range(12):
        s.tick()
    hi = s.push(R(rid=1, prompt=np.ones(4, np.int32)), priority=2)
    assert s.effective_priority(lo) == 3 > s.effective_priority(hi)
    assert s.peek() is lo
    s.requeue(lo)                        # fresh aging clock
    assert s.effective_priority(lo) == 0
    assert s.peek() is hi


@pytest.mark.parametrize("S", [Scheduler, JScheduler], ids=["port", "jax"])
def test_scheduler_victim_policy(S):
    s = S()
    # (slot, priority, pages, progress): lowest priority first...
    assert s.select_victim([(0, 1, 9, 0), (1, 0, 1, 9)]) == 1
    # ...then most pages held...
    assert s.select_victim([(0, 0, 2, 5), (1, 0, 6, 5)]) == 1
    # ...then least progress, then latest slot
    assert s.select_victim([(0, 0, 4, 7), (1, 0, 4, 2)]) == 1
    assert s.select_victim([(0, 0, 4, 2), (1, 0, 4, 2)]) == 1
    assert s.select_victim([]) is None
    assert S(policy="never").select_victim([(0, 0, 1, 0)]) is None


@pytest.mark.parametrize("S", [Scheduler, JScheduler], ids=["port", "jax"])
def test_scheduler_bad_policy_fails_construction(S):
    with pytest.raises(ValueError, match="serve_preempt_policy"):
        S(policy="typo")


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_seeded_operations_match_jax(seed):
    """push / requeue / tick / peek / pop / remove and victim choices in
    one seeded sequence, on both schedulers: the same entry heads the
    queue, with the same effective priority, after every operation."""
    rng = np.random.default_rng(seed)
    aging = int(rng.integers(0, 5))
    port, jax_ = Scheduler(aging=aging), JScheduler(aging=aging)
    queued = []                          # (port entry, jax entry)
    parked = []
    rid = 0
    for _ in range(200):
        op = int(rng.integers(0, 6))
        if op == 0:                      # push
            prio = None if rng.random() < 0.3 else int(rng.integers(0, 3))
            n = int(rng.integers(1, 6))
            queued.append((port.push(Request(rid=rid, prompt=np.ones(n, np.int32),
                                             priority=prio), prio),
                           jax_.push(JRequest(rid=rid, prompt=np.ones(n, np.int32),
                                              priority=prio), prio)))
            rid += 1
        elif op == 1:                    # tick
            port.tick()
            jax_.tick()
        elif op == 2 and queued:         # admit the head
            a, b = port.peek(), jax_.peek()
            pair = next(p for p in queued if p[0] is a)
            assert pair[1] is b
            port.pop(a)
            jax_.pop(b)
            queued.remove(pair)
            parked.append(pair)
        elif op == 3 and parked:         # preempt an admitted entry
            pair = parked.pop(int(rng.integers(len(parked))))
            port.requeue(pair[0])
            jax_.requeue(pair[1])
            queued.append(pair)
        elif op == 4 and queued:         # drop a queued entry
            pair = queued.pop(int(rng.integers(len(queued))))
            port.remove(pair[0])
            jax_.remove(pair[1])
        else:                            # a victim among random live slots
            cands = [tuple(int(x) for x in (i, *rng.integers(0, 4, 3)))
                     for i in range(int(rng.integers(0, 5)))]
            assert port.select_victim(cands) == jax_.select_victim(cands)
        a, b = port.peek(), jax_.peek()
        assert (a is None) == (b is None)
        if a is not None:
            assert a.req.rid == b.req.rid
            assert port.effective_priority(a) == jax_.effective_priority(b)
        assert len(port) == len(jax_)
        port.check()
        jax_.check()
    js, ps = jax_.stats(), port.stats()
    # queue waits are wall-clock: the same number of admissions observed
    assert ps.pop("queue_wait_s")["count"] == js["queue_wait_s"]["count"]
    assert ps == {k: js[k] for k in ps}
