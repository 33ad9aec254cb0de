"""A serving handle keeps one cache: ``reset`` rewinds it in place
(``Model.reset_cache``), with no second, empty copy to restore from."""

import numpy as np
import pytest
import torch

from repro_torch import Session, configs
from repro_torch.core import lightweight

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each


@pytest.mark.parametrize("arch,kw", [
    ("bert-base", dict(paged=True)), ("bert-base", dict(paged=False)),
    ("mamba2-130m", {})])
def test_reset_rewinds_the_one_cache_in_place(arch, kw):
    sess = Session.init(configs.smoke_config(arch), seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, sess.cfg.vocab_size, (2, 12))
    handle = sess.serve(2, 32, weight_cache=False, **kw)
    assert not hasattr(handle, "_cache0")
    leaves = lambda c: lightweight.leaves(c) if isinstance(c, dict) else [c]
    ptrs = [t.data_ptr() for t in leaves(handle.cache)]
    first = handle.generate({"tokens": prompts}, 6)
    handle.reset()
    # the same tensors, back to what a fresh handle starts from
    assert [t.data_ptr() for t in leaves(handle.cache)] == ptrs
    fresh = sess.serve(2, 32, weight_cache=False, **kw).cache
    if isinstance(fresh, dict):
        assert sorted(fresh) == sorted(handle.cache)
        for name in fresh:
            assert torch.equal(handle.cache[name], fresh[name]), name
    else:
        assert torch.equal(handle.cache, fresh)
    again = handle.generate({"tokens": prompts}, 6)
    assert torch.equal(first, again)
