"""The control (the reference in bfloat16 in the program's place) comes
out as not correct, at a size the CPU holds, for both routes."""

import torch

from anns_bench.control import control_numbers
from anns_bench.tests.small import small_cell


def test_control_is_not_correct_on_search():
    out = control_numbers(small_cell("sift1m-ivfpq-triage.search-b64"), 17,
                          torch.device("cpu"))
    assert not out["correct"]
    assert out["checks"]["dist_gap"]["value"] > 0


def test_control_is_not_correct_on_the_encrypted_route():
    out = control_numbers(small_cell("sift1m-bfv-packed.rerank-b64"), 17,
                          torch.device("cpu"))
    assert not out["correct"]
    assert out["checks"]["dist_gap"]["value"] > 0
