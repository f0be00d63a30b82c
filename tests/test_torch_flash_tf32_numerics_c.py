"""The fp32 flash kernel's arithmetic (``tests/_torch_tf32_model.py``) at
phase B's GQA shape (H = 8 on K = 2, hd 64) causal over a ragged S of
1000 keys: a case of ``test_torch_flash_tf32_numerics.py``'s CASES, in a
file of its own so that the test workers share the model's time.
"""
import pytest

from _torch_tf32_model import case_id, hold_the_fp32_limit
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = [(1, 1000, 8, 2, 64, True)]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_three_tf32_products_hold_the_fp32_limit(case):
    hold_the_fp32_limit(case)
