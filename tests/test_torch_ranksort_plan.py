"""The launch plan of the rank sort (#5) on the CPU: ``sort_plan``'s
threads a block and words a thread for every N the kernel takes, held to
the rules ``csrc/ranksort.cu``'s entry point checks (transcribed here from
``plan_words``), and its shared-memory steps to a count of the bitonic
network's strides.  The constants are read from the
C source, so a plan never hands the kernel what it would refuse."""

from __future__ import annotations

import os
import re

import pytest

from scanobjectnn_torch.ops.cuda import ranksort_kernel
from scanobjectnn_torch.ops.cuda.ranksort_kernel import (
    MAX_N,
    MAX_THREADS,
    PER_THREAD,
    WARP,
    shared_steps,
    sort_plan,
    sort_words,
)

SOURCE = os.path.join(os.path.dirname(ranksort_kernel.__file__), os.pardir, os.pardir, "csrc", "ranksort.cu")


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("py,c_name", [(MAX_N, "kMaxN"), (MAX_THREADS, "kMaxThreads"), (WARP, "kWarp")])
def test_constants_mirror_the_kernel_source(py, c_name):
    m = re.search(rf"constexpr int {c_name} = (\d+);", _source())
    assert m and int(m.group(1)) == py


def test_words_a_thread_mirror_the_kernel_source():
    m = re.search(r"if \((per_thread != \d+(?: && per_thread != \d+)*)\) return 0;", _source())
    assert m and tuple(int(v) for v in re.findall(r"\d+", m.group(1))) == PER_THREAD


def _c_plan_words(n: int, threads: int, per_thread: int) -> int:
    """``plan_words`` of csrc/ranksort.cu: the padded width, or 0 where the
    entry point refuses the plan."""
    if not 1 <= n <= MAX_N or per_thread not in PER_THREAD:
        return 0
    p = WARP * per_thread
    while p < n:
        p <<= 1
    return p if threads * per_thread == p and threads <= MAX_THREADS else 0


def _strides_through_shared_memory(p: int, per_thread: int) -> int:
    """The bitonic network's compare-exchange steps over P words whose
    stride is a warp's words (32 E) or more."""
    steps, size = 0, 2
    while size <= p:
        j = size // 2
        while j >= 1:
            steps += j >= WARP * per_thread
            j //= 2
        size *= 2
    return steps


@pytest.mark.parametrize("first", range(1, MAX_N + 1, 1024))
def test_every_plan_is_one_the_kernel_takes(first):
    for n in range(first, min(first + 1024, MAX_N + 1)):
        threads, per = sort_plan(n)
        p = _c_plan_words(n, threads, per)
        assert p == threads * per == sort_words(n, per), n
        assert threads % WARP == 0 and threads <= MAX_THREADS and per in PER_THREAD, n
        # No padding past the least power of two that gives whole warps.
        assert p < 2 * n or threads == WARP, n
        assert shared_steps(threads) == _strides_through_shared_memory(p, per), n


# n -> (threads, words a thread, shared-memory steps): the SSG SA1
# prep's two calls (points N=2048, queries M=512), and the plan's edges.
PLANS = {
    1: (32, 1, 0),
    32: (32, 1, 0),
    33: (32, 2, 0),
    65: (32, 4, 0),
    129: (64, 4, 1),
    257: (128, 4, 3),
    512: (128, 4, 3),
    1024: (256, 4, 6),
    1025: (256, 8, 6),
    2047: (256, 8, 6),
    2048: (256, 8, 6),
    8192: (1024, 8, 15),
    8193: (1024, 16, 15),
    16384: (1024, 16, 15),
}


@pytest.mark.parametrize("n", sorted(PLANS))
def test_main_path_and_edge_plans(n):
    threads, per = sort_plan(n)
    assert (threads, per, shared_steps(threads)) == PLANS[n]


@pytest.mark.parametrize("n", [0, MAX_N + 1])
def test_plan_refuses_what_the_kernel_does_not_take(n):
    with pytest.raises(ValueError):
        sort_plan(n)
