"""The reader of worst_chain_accept on synthetic runs: the median over the
window's calls of the ``sample`` span's value, read only from the sampling
phase's span, and None where no call's trace carries it (as a program
without the counter reads)."""

from types import SimpleNamespace

from port_bench.harness import manifest


def call(worst=None, nested=True):
    attrs = {} if worst is None else {"worst_chain_accept": worst}
    spans = [{"id": 0, "parent": None, "name": "predict", "attrs": {}},
             {"id": 1, "parent": 0, "name": "sampling", "attrs": {}},
             {"id": 2, "parent": 1 if nested else 0, "name": "sample",
              "attrs": attrs}]
    return SimpleNamespace(timings={"trace": {"spans": spans}})


def read(calls):
    return manifest.reader("worst_chain_accept")(SimpleNamespace(calls=calls))


def test_the_median_over_the_calls():
    assert read([call(0.4), call(0.1), call(0.6)]) == 0.4
    assert read([call(0.2), call(0.5)]) == 0.35
    assert read([call(0.0), call(None), call(0.3)]) == 0.15


def test_none_without_the_counter():
    assert read([]) is None
    assert read([call(None), call(None)]) is None
    assert read([SimpleNamespace(timings=None)]) is None
    # a sample span outside a sampling phase is not the phase's
    assert read([call(0.4, nested=False)]) is None
