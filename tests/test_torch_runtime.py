"""The port's kernel build bookkeeping: hash-named libraries, refusals,
and the launch counters."""

import threading

import pytest

from pl_bert_tpu_torch.runtime import build


def test_library_path_keys_on_sources_and_flags():
    plain = build.library_path("attention_block")
    assert plain == build.library_path("attention_block")
    assert plain.parent == build.BUILD_DIR and plain.suffix == ".so"
    assert build.library_path("attention_block", ("-Xptxas", "-v")) != plain
    assert "attention_block" in build.all_sources()


def test_missing_source_raises():
    with pytest.raises(build.BuildError, match="no CUDA source"):
        build.build("no_such_kernel")


def test_check_raises_on_nonzero_status():
    build.check(0, "ok")
    for status in (-1, 700):
        with pytest.raises(RuntimeError, match=f"CUDA error {status}"):
            build.check(status, "kernel")


def test_launch_counter_counts_across_threads():
    counter = build.LaunchCounter("k")
    threads = [
        threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
        for _ in range(8)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert counter.count == 16000
    counter.reset()
    assert counter.count == 0
