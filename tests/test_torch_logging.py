"""The port's ``setup_logging`` (``lmrs_tpu_torch/utils/logging.py``)
against the JAX package's: one managed handler updated in place by a
repeated call (level, stream, format), a foreign handler left alone, and
``LMRS_LOG_JSON`` lines with the same keys.  The port configures the
``lmrs_torch`` logger tree where the reference configures ``lmrs``."""

from __future__ import annotations

import io
import json
import logging

import pytest

from lmrs_tpu.utils import logging as jlog

from lmrs_tpu_torch.utils import logging as tlog

PACKAGES = {"jax": (jlog, "lmrs"), "port": (tlog, "lmrs_torch")}


@pytest.fixture
def fresh():
    """Both trees without handlers and at their default level, restored
    after the test."""
    saved = {}
    for _, name in PACKAGES.values():
        root = logging.getLogger(name)
        saved[name] = (root.handlers[:], root.level)
        root.handlers = []
    yield
    for name, (handlers, level) in saved.items():
        root = logging.getLogger(name)
        root.handlers = handlers
        root.setLevel(level)


def _run(mod, name: str, env: dict, monkeypatch, calls) -> list:
    """The managed handler's state after each call of ``calls``, plus what
    one record per level wrote to the last stream."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    root = logging.getLogger(name)
    states = []
    for kw in calls:
        mod.setup_logging(**kw)
        managed = [h for h in root.handlers if getattr(h, "_lmrs_managed", 0)]
        states.append((len(root.handlers), len(managed), root.level,
                       type(managed[0].formatter).__name__ if managed else None))
    return states


@pytest.mark.parametrize("json_on", ["0", "1"])
def test_repeated_calls_update_one_managed_handler(fresh, monkeypatch,
                                                   json_on):
    got = {}
    for key, (mod, name) in PACKAGES.items():
        bufs = [io.StringIO(), io.StringIO()]
        got[key] = _run(mod, name, {"LMRS_LOG_JSON": json_on}, monkeypatch, [
            {"stream": bufs[0]}, {"quiet": True, "stream": bufs[1]},
            {"level": logging.DEBUG}])
        logging.getLogger(name + ".test").debug("after the swap")
        assert bufs[0].getvalue() == "" and "after the swap" in bufs[1].getvalue()
    assert got["port"] == got["jax"]
    assert [s[2] for s in got["port"]] == [logging.INFO, logging.WARNING,
                                           logging.DEBUG]
    assert {s[:2] for s in got["port"]} == {(1, 1)}


def test_swap_away_from_a_closed_stream(fresh):
    """A CLI run after the stream its last run logged to was closed (a
    test's captured stderr, a redirected and closed file) re-points the
    handler instead of raising."""
    old, new = io.StringIO(), io.StringIO()
    tlog.setup_logging(stream=old)
    old.close()
    tlog.setup_logging(quiet=True, stream=new)
    logging.getLogger("lmrs_torch.test").warning("to the new stream")
    assert "to the new stream" in new.getvalue()
    tlog.setup_logging(stream=new)  # the same stream again: no swap
    assert logging.getLogger("lmrs_torch").handlers[0].stream is new


def test_foreign_handler_is_left_alone(fresh):
    for mod, name in PACKAGES.values():
        root = logging.getLogger(name)
        foreign = logging.StreamHandler(io.StringIO())
        fmt = foreign.formatter
        root.addHandler(foreign)
        mod.setup_logging(quiet=True, stream=io.StringIO())
        assert root.handlers == [foreign] and foreign.formatter is fmt
        assert root.level == logging.WARNING


def test_json_lines_carry_the_same_keys(fresh, monkeypatch):
    monkeypatch.setenv("LMRS_LOG_JSON", "1")
    lines = {}
    for key, (mod, name) in PACKAGES.items():
        buf = io.StringIO()
        mod.setup_logging(stream=buf)
        log = logging.getLogger(name + ".test")
        log.info("structured hello")
        try:
            raise ValueError("boom")
        except ValueError:
            log.exception("with a traceback")
        lines[key] = [json.loads(x) for x in buf.getvalue().splitlines()]
    for a, b in zip(lines["jax"], lines["port"]):
        assert set(a) == set(b)
        assert (a["level"], a["msg"]) == (b["level"], b["msg"])
        assert b["logger"] == "lmrs_torch.test"
    assert "exc" in lines["port"][1] and "boom" in lines["port"][1]["exc"]
    monkeypatch.setenv("LMRS_LOG_JSON", "0")  # re-read on every call
    buf = io.StringIO()
    tlog.setup_logging(stream=buf)
    logging.getLogger("lmrs_torch.test").info("plain again")
    assert " - lmrs_torch.test - INFO - plain again" in buf.getvalue()


def test_cli_quiet_configures_the_port_tree(fresh, tmp_path):
    """``lmrs-torch -q`` sets up the ``lmrs_torch`` tree (WARNING, one
    managed handler) and adds no handler to the root logger."""
    from lmrs_tpu_torch.cli import main

    before = logging.getLogger().handlers[:]
    main(["--input", str(tmp_path / "missing.json"), "--output",
          str(tmp_path / "s.txt"), "--backend", "mock", "-q"])
    root = logging.getLogger("lmrs_torch")
    assert root.level == logging.WARNING
    assert [getattr(h, "_lmrs_managed", False) for h in root.handlers] == [True]
    assert logging.getLogger().handlers == before
