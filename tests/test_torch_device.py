"""utils/device.py::full_float32 when threads overlap: an evaluation on a
thread of its own beside a train step.  The flags stay off until the
last thread leaves and then return to the values saved when the first
one entered (the torch flags can be set on a CPU build)."""

import threading

import torch

from nhans_tpu_torch.utils.device import full_float32


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_overlapping_threads_keep_tf32_off_until_the_last_leaves():
    saved = _flags()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        a_in, b_in, a_out, b_done = (threading.Event() for _ in range(4))
        seen = {}

        def first():                       # enters first, leaves first
            with full_float32():
                a_in.set()
                assert b_in.wait(10)
                seen["a_inside"] = _flags()
            a_out.set()

        @full_float32()
        def second():                      # enters second, leaves last
            b_in.set()
            assert a_out.wait(10)
            seen["b_after_a_left"] = _flags()
            with full_float32():           # nested in one thread
                pass
            seen["b_after_nested"] = _flags()

        ta = threading.Thread(target=first)
        ta.start()
        assert a_in.wait(10)
        tb = threading.Thread(target=lambda: (second(), b_done.set()))
        tb.start()
        ta.join(10)
        tb.join(10)
        assert not ta.is_alive() and not tb.is_alive() and b_done.is_set()
        assert seen == {"a_inside": (False, False),
                        "b_after_a_left": (False, False),
                        "b_after_nested": (False, False)}
        assert _flags() == (True, True)
        with full_float32():
            assert _flags() == (False, False)
        assert _flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def test_flags_come_back_after_an_exception():
    saved = _flags()
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with full_float32():
                raise KeyError("x")
        except KeyError:
            pass
        assert _flags() == (False, True)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
