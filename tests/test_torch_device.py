"""`core.device.fp32_convolutions` across threads.

The TF32 flags are global to the process. The trainer's prefetch thread runs
the face models under `fp32_convolutions` while the main thread opens and
closes its own blocks (the student step's backward, the GMA flow, the
losses' face models). Each test interleaves two threads with events in the
order that exposed the fault: the first block closes while the second is
still open. No card is needed: the flags are plain settings of torch's
backends on the CPU too.
"""

import threading

import pytest
import torch

from adaface_tpu_torch.core.device import fp32_convolutions

WAIT = 10.0  # seconds an event may take before the test fails instead of hanging


@pytest.fixture
def tf32_flags():
    """The flags as the test found them, restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def interleave(first_kw: dict, second_kw: dict, read):
    """Thread 1 opens a block, thread 2 opens one, thread 1 closes, thread 2
    calls `read()` inside its block and closes. → what `read()` gave."""
    opened1, opened2, closed1 = threading.Event(), threading.Event(), threading.Event()
    seen, errors = [], []

    def first():
        try:
            with fp32_convolutions(**first_kw):
                opened1.set()
                assert opened2.wait(WAIT)
        except BaseException as e:  # noqa: BLE001 (re-raised in the main thread)
            errors.append(e)
        finally:
            opened1.set()
            closed1.set()

    def second():
        try:
            assert opened1.wait(WAIT)
            with fp32_convolutions(**second_kw):
                opened2.set()
                assert closed1.wait(WAIT)
                seen.append(read())
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            opened2.set()

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * WAIT)
    if errors:
        raise errors[0]
    return seen[0]


@pytest.mark.parametrize("start", [True, False])
def test_a_block_stays_fp32_after_the_other_threads_block_closes(tf32_flags, start):
    """The second thread's block still reads TF32 off after the first
    thread's block has closed, and the flag ends as it began."""
    torch.backends.cudnn.allow_tf32 = start
    inside = interleave({}, {}, lambda: torch.backends.cudnn.allow_tf32)
    assert inside is False
    assert torch.backends.cudnn.allow_tf32 is start


@pytest.mark.parametrize("start", [True, False])
def test_matmul_flag_across_threads(tf32_flags, start):
    """The same interleaving with `matmuls=True` on both sides: cuBLAS's
    flag too stays off inside the second block and ends as it began."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = start
    inside = interleave({"matmuls": True}, {"matmuls": True},
                        lambda: (torch.backends.cudnn.allow_tf32,
                                 torch.backends.cuda.matmul.allow_tf32))
    assert inside == (False, False)
    assert torch.backends.cudnn.allow_tf32 is start
    assert torch.backends.cuda.matmul.allow_tf32 is start


def test_a_convolutions_only_block_leaves_the_matmul_flag_alone(tf32_flags):
    """A block without `matmuls` closing under another thread's block with
    it does not restore cuBLAS's flag; nested in one thread, it does not
    touch the flag either."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    inside = interleave({}, {"matmuls": True},
                        lambda: (torch.backends.cudnn.allow_tf32,
                                 torch.backends.cuda.matmul.allow_tf32))
    assert inside == (False, False)
    with fp32_convolutions(matmuls=True):
        with fp32_convolutions():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    with fp32_convolutions():
        assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_decorator_and_exception_restore(tf32_flags):
    """As a decorator each call opens its own block, and a block that raises
    still closes."""
    torch.backends.cudnn.allow_tf32 = True

    @fp32_convolutions()
    def forward(fail: bool):
        assert torch.backends.cudnn.allow_tf32 is False
        if fail:
            raise ValueError("inside")

    forward(False)
    assert torch.backends.cudnn.allow_tf32 is True
    with pytest.raises(ValueError):
        forward(True)
    assert torch.backends.cudnn.allow_tf32 is True
