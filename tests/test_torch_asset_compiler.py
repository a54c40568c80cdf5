"""The AssetCompiler in the port (editor/asset_compiler.py): the five
scenarios of tests/test_asset_compiler.py (the watcher, the content-hash
cache, a change recompiling with a version bump, a dependency recompiling
its product, the engine frame polling the compiler) on the port's classes,
and ``Engine.update_host`` polling an attached compiler with its plugins
and listeners, as the JAX package's engine does."""
import os
import time

import pytest

from lumixengine_tpu_torch.editor.asset_compiler import AssetCompiler, FileSystemWatcher


@pytest.fixture
def touch():
    n = [0.0]

    def _touch(path, content):
        with open(path, "w") as f:
            f.write(content)
        os.utime(path, (time.time(), time.time() + 0.01 + n[0]))   # mtime resolution guard
        n[0] += 1.0

    return _touch


def test_watcher_reports_changes(tmp_path, touch):
    p = str(tmp_path / "a.txt")
    touch(p, "one")
    w = FileSystemWatcher()
    w.watch(p)
    assert w.poll() == []
    touch(p, "two")
    assert w.poll() == [p]
    assert w.poll() == []
    os.remove(p)
    assert w.poll() == [p]                 # a deleted file is a change too
    w.unwatch(p)
    assert w.poll() == []


def test_compile_caches_by_content_hash(tmp_path, touch):
    p = str(tmp_path / "s.pat")
    touch(p, "source-a")
    calls = []
    ac = AssetCompiler()
    ac.add_plugin("pat", lambda path, src: calls.append(path) or src.upper())
    assert ac.compile(p) == b"SOURCE-A"
    ac.compile(p)
    assert len(calls) == 1                 # content unchanged: a cache hit
    with pytest.raises(KeyError, match="no asset plugin"):
        ac.compile(str(tmp_path / "x.unknown"))


def test_change_triggers_recompile_and_version_bump(tmp_path, touch):
    p = str(tmp_path / "s.pat")
    touch(p, "v1")
    ac = AssetCompiler()
    ac.add_plugin("pat", lambda path, src: src.decode())
    compiled = []
    ac.on_compiled(lambda path, out: compiled.append(out))
    assert ac.compile(p) == "v1"
    v0 = ac.version(p)
    touch(p, "v2")
    ac.poll()
    assert ac.get(p) == "v2"
    assert ac.version(p) == v0 + 1
    assert compiled == ["v1", "v2"]


def test_dependency_recompiles_product(tmp_path, touch):
    lib = str(tmp_path / "common.pai")
    prod = str(tmp_path / "fx.pat")
    touch(lib, "lib-1")
    touch(prod, "import lib")
    ac = AssetCompiler()

    def compile_pat(path, src):
        with open(lib) as f:
            return (src.decode(), f.read())

    ac.add_plugin("pat", compile_pat)
    ac.register_dependency(prod, lib)
    assert ac.compile(prod)[1] == "lib-1"
    touch(lib, "lib-2")
    ac.poll()
    assert ac.get(prod)[1] == "lib-2"      # the product recompiled on the dependency's change


def test_a_failed_recompile_keeps_watching(tmp_path, touch):
    p = str(tmp_path / "s.pat")
    touch(p, "ok")
    ac = AssetCompiler()
    ac.add_plugin("pat", lambda path, src: src.decode() if src != b"bad" else 1 / 0)
    ac.compile(p)
    touch(p, "bad")
    ac.poll()                               # logged, not raised
    assert ac.get(p) == "ok" and ac.version(p) == 1
    touch(p, "fixed")
    ac.poll()
    assert ac.get(p) == "fixed" and ac.version(p) == 2


@pytest.mark.parametrize("with_system", [False, True])
def test_engine_frame_polls_compiler(tmp_path, touch, with_system):
    """Engine.update_host polls the attached compiler at the end of the
    host frame: a changed source is recompiled by the frame, not later."""
    from lumixengine_tpu_torch.engine.engine import Engine

    p = str(tmp_path / "s.pat")
    touch(p, "v1")
    engine = Engine()
    if with_system:
        from lumixengine_tpu_torch.app import create_full_engine

        engine = create_full_engine(device="cpu")
    ac = AssetCompiler()
    ac.add_plugin("pat", lambda path, src: src.decode())
    engine.asset_compiler = ac
    ac.compile(p)
    touch(p, "v2")
    engine.update_host(1 / 60)
    assert ac.version(p) == 2               # recompiled inside the frame
    assert ac.get(p) == "v2"
    del engine.asset_compiler
    touch(p, "v3")
    engine.update_host(1 / 60)              # nothing attached: nothing polled
    assert ac.version(p) == 2
