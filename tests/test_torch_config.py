"""The port's config loader (``niceslam_tpu_torch/config/schema.py``) on
files written here: the order of its layers, held against the JAX
package's loader, and a cyclic ``inherit_from``, which the port refuses
with a ``ValueError`` naming the files (the JAX loader recurses without
end there, so it is not asked)."""
import pytest

from niceslam_tpu.config.schema import load_config as jax_load_config
from niceslam_tpu_torch.config.schema import load_config


def _write(path, text):
    path.write_text(text)
    return path


def test_base_lies_under_the_inherit_from_chain(tmp_path):
    """Every layer sets ``tracking.lr``: the chain's parent beats ``base``,
    the file beats its parent, an override beats the file; keys set only
    lower down come through. The JAX loader gives the same values."""
    base = _write(tmp_path / "base.yaml",
                  "tracking: {lr: 0.1, iters: 7}\nmapping: {iters: 11}\nscale: 2.0\n")
    _write(tmp_path / "parent.yaml", "tracking: {lr: 0.2}\nmapping: {pixels: 123}\n")
    child = _write(tmp_path / "child.yaml",
                   "inherit_from: parent.yaml\ntracking: {lr: 0.3}\nmapping: {iters: 13}\n")
    alone = _write(tmp_path / "alone.yaml", "mapping: {pixels: 77}\n")
    cases = [
        (dict(path=child, base=base), (0.3, 7, 13, 123, 2.0)),
        (dict(path=tmp_path / "parent.yaml", base=base), (0.2, 7, 11, 123, 2.0)),
        (dict(path=alone, base=base), (0.1, 7, 11, 77, 2.0)),
        (dict(path=child, base=base, overrides={"tracking.lr": 0.4}), (0.4, 7, 13, 123, 2.0)),
    ]
    for kwargs, want in cases:
        for load in (load_config, jax_load_config):
            cfg = load(**kwargs)
            got = (cfg.tracking.lr, cfg.tracking.iters, cfg.mapping.iters, cfg.mapping.pixels,
                   cfg.scale)
            assert got == want, (load.__module__, kwargs)


@pytest.mark.parametrize("files,cycle", [
    ({"a.yaml": "inherit_from: a.yaml\nscale: 1.0\n"}, ["a.yaml", "a.yaml"]),
    ({"a.yaml": "inherit_from: b.yaml\nscale: 1.0\n", "b.yaml": "inherit_from: a.yaml\n"},
     ["a.yaml", "b.yaml", "a.yaml"]),
    ({"a.yaml": "inherit_from: sub/b.yaml\n", "sub/b.yaml": "inherit_from: ../c.yaml\n",
      "c.yaml": "inherit_from: sub/b.yaml\n"}, ["sub/b.yaml", "c.yaml", "sub/b.yaml"]),
], ids=["self", "two-files", "into-a-cycle-through-a-directory"])
@pytest.mark.parametrize("as_base", [False, True])
def test_an_inherit_from_cycle_raises_naming_the_files(tmp_path, files, cycle, as_base):
    """A file that inherits from itself, two that inherit from each other,
    and a chain that runs into a cycle of two: ``ValueError`` with the
    cycle's files in order, as ``path`` and as ``base``."""
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        _write(tmp_path / name, text)
    kwargs = {"base" if as_base else "path": tmp_path / "a.yaml"}
    with pytest.raises(ValueError, match="inherit_from cycle") as err:
        load_config(**kwargs)
    want = " -> ".join(str((tmp_path / name).resolve()) for name in cycle)
    assert str(err.value) == f"inherit_from cycle: {want}"
