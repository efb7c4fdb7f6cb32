"""Platform plumbing: the CLI's backend choice, the compile-cache
directory rule, and the index placement of a multi-device aligner."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from bwa_mem_scale_tpu import cli
from bwa_mem_scale_tpu.utils import compile_cache


@pytest.mark.parametrize("plat", ["rocm", "cuda,cpu"])
def test_cli_platform_rejects_anything_but_cpu_or_gpu(plat, capsys):
    assert cli.main(["--platform", plat, "version"]) == 1
    assert "cpu or gpu" in capsys.readouterr().err


def test_compile_cache_dir_rule(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: no directory set in code; unset:
    the checkout's .jax_cache."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("BWATPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    compile_cache.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in calls
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert calls["jax_compilation_cache_dir"] == os.path.join(
        repo, ".jax_cache")


def test_mesh_aligner_places_index_once_per_device(small_index):
    """With a mesh, every index array is replicated across the mesh's
    devices at construction, not left on the first device."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from bwa_mem_scale_tpu.parallel.mesh import make_mesh
    from bwa_mem_scale_tpu.pipeline.align import TpuAligner
    al = TpuAligner(small_index, mesh=make_mesh(4))
    leaves = jax.tree_util.tree_leaves((al.fmi, al.dbns))
    assert leaves
    for leaf in leaves:
        sh = leaf.sharding
        assert isinstance(sh, NamedSharding) and sh.is_fully_replicated
        assert sh.device_set == set(jax.devices()[:4])
    np.testing.assert_array_equal(np.asarray(al.fmi.count),
                                  np.asarray(small_index.count))
