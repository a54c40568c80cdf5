"""The terminal backend in the port (core/os_terminal.py): the five
scenarios of tests/test_os_terminal.py (key parsing into press, release and
text events, Ctrl-C quitting through the OS layer, keys reaching the input
system, a half-block present, enter and exit without a tty), and the ANSI
output of ``ansi_image`` and ``present`` string-equal to the JAX package's
for the same images."""
import io

import numpy as np
import pytest

from lumixengine_tpu.core.os_terminal import TerminalWindowBackend as RBackend
from lumixengine_tpu_torch.core.os import EventType, OSLayer
from lumixengine_tpu_torch.core.os_terminal import TerminalWindowBackend


def _backend(out=None, cls=TerminalWindowBackend):
    be = cls(out=out or io.StringIO())
    be._raw_fd = None          # no tty here: input is fed through _read_pending
    return be


def test_key_parse_press_release_and_text():
    be = _backend()
    be._read_pending = lambda: "w\x1b[A\x1b[5~q\x7f\r"
    evs = be.poll()
    keys = [(e.keycode, e.down) for e in evs if e.type == EventType.KEY]
    assert (ord("W"), True) in keys and (0x26, True) in keys
    assert (ord("Q"), True) in keys and (8, True) in keys and (13, True) in keys
    assert [e.text for e in evs if e.type == EventType.TEXT_INPUT] == ["w", "q"]
    be._read_pending = lambda: ""
    ups = [(e.keycode, e.down) for e in be.poll() if e.type == EventType.KEY]
    assert (ord("W"), False) in ups and (0x26, False) in ups
    assert be.poll() == []


def test_ctrl_c_quits_through_os_layer():
    be = _backend()
    be._read_pending = lambda: "\x03"
    osl = OSLayer(be)
    osl.process_events()
    assert osl.quit_requested


def test_keys_reach_input_system():
    from lumixengine_tpu_torch.engine import input as inp

    be = _backend()
    be._read_pending = lambda: "d"
    osl = OSLayer(be)
    isys = inp.InputSystem()
    osl.process_events(isys)
    isys.update()
    assert isys.is_down(ord("D"))


def test_present_emits_half_block_frame():
    out = io.StringIO()
    be = _backend(out)
    be.term_size = lambda: (20, 11)
    img = np.zeros((40, 80, 3), np.uint8)
    img[:20] = [255, 0, 0]
    img[20:] = [0, 0, 255]
    frame = be.present(img)
    assert frame.startswith("\x1b[H")
    assert frame.count("▀") == 20 * 10
    assert "\x1b[38;2;255;0;0m" in frame and "\x1b[48;2;0;0;255m" in frame
    assert out.getvalue() == frame


def test_enter_exit_safe_without_tty():
    out = io.StringIO()
    be = TerminalWindowBackend(out=out)
    with be:
        pass
    s = out.getvalue()
    assert "\x1b[?1049h" in s and "\x1b[?1049l" in s
    be.exit()                                   # a second exit writes nothing
    assert out.getvalue() == s
    assert be.term_size() == (80, 24)           # no terminal behind a buffer


@pytest.mark.parametrize("shape", [(7, 5), (36, 64), (180, 320)])
def test_ansi_output_string_equal_to_reference(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    img[: shape[0] // 3] = [12, 200, 40]        # runs of one colour share escapes
    assert TerminalWindowBackend.ansi_image(img) == RBackend.ansi_image(img)
    frames = []
    for cls in (RBackend, TerminalWindowBackend):
        out = io.StringIO()
        be = _backend(out, cls)
        be.term_size = lambda: (57, 19)
        frames.append((be.present(img), out.getvalue()))
    assert frames[1] == frames[0]
    out = io.StringIO()                          # the default size: no terminal behind it
    assert _backend(out).present(img) == _backend(io.StringIO(), RBackend).present(img)
