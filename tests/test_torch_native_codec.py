"""The port's native PQR codec and restart writer (runtime/native.py, its
copy of mpmcio.cpp) against its pure-Python path and against the JAX
package's native codec, on the same inputs: every PQR under examples/,
the goldens' literal PQR (``pqr_text``) and the goldens' atom tables.
Parsing gives the same records and formatting the same bytes, exactly.
Also: an async write with ``.last`` rotation then ``drain()``; the
library is built under mpmcxx_tpu_torch/_build/ (never the JAX
package's runtime/libmpmcio.so); without g++ the Python path runs and
writes the same bytes; a compile that fails with g++ present raises."""

import glob
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mpmcxx_tpu.io import pqr as pqr_j  # noqa: E402
from mpmcxx_tpu.runtime import native as native_j  # noqa: E402
from mpmcxx_tpu.state import AtomRecord as AtomRecord_j  # noqa: E402
from mpmcxx_tpu.state import build_state as build_j  # noqa: E402
from mpmcxx_tpu_torch.constants import E2REDUCED  # noqa: E402
from mpmcxx_tpu_torch.io import pqr as pqr_t  # noqa: E402
from mpmcxx_tpu_torch.runtime import native as native_t  # noqa: E402
from mpmcxx_tpu_torch.state import AtomRecord as AtomRecord_t  # noqa: E402
from mpmcxx_tpu_torch.state import build_state as build_t  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLE_PQRS = sorted(glob.glob(os.path.join(REPO, "examples", "*",
                                             "*.pqr")))
GOLDENS = sorted(glob.glob(os.path.join(HERE, "golden", "*.json")))


def _golden(path):
    with open(path) as f:
        return json.load(f)


PQR_TEXT_GOLDENS = [p for p in GOLDENS if "pqr_text" in _golden(p)]
ATOM_GOLDENS = [p for p in GOLDENS if "atoms" in _golden(p)]


def _python_path(monkeypatch):
    """Make the port's codec unavailable: its callers take Python."""
    monkeypatch.setattr(native_t, "get_lib", lambda: None)


def _text(source):
    if source.endswith(".json"):
        return _golden(source)["pqr_text"]
    with open(source) as f:
        return f.read()


def _formats(atoms_t, atoms_j, basis, monkeypatch):
    """The PQR text of the same atoms through the port's codec, the
    port's Python path and the JAX package's native codec, each with
    long_output off and on."""
    assert native_t.get_lib() is not None and native_j.get_lib() is not None
    st, mt = build_t(atoms_t, basis, device="cpu")
    sj, mj = build_j(atoms_j, basis)
    out = {"codec": [], "python": [], "jax": []}
    for long_output in (False, True):
        data_t = pqr_t.state_to_atoms_data(st, mt)
        data_j = pqr_j.state_to_atoms_data(sj, mj)
        out["codec"].append(pqr_t.format_pqr(data_t, basis,
                                             long_output=long_output))
        out["jax"].append(pqr_j.format_pqr(data_j, basis,
                                           long_output=long_output))
    with monkeypatch.context() as m:
        _python_path(m)
        for long_output in (False, True):
            out["python"].append(pqr_t.format_pqr(
                pqr_t.state_to_atoms_data(st, mt), basis,
                long_output=long_output))
    return out


@pytest.mark.parametrize("source", EXAMPLE_PQRS + PQR_TEXT_GOLDENS,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_parse_and_format_match(source, monkeypatch):
    """Every example PQR and golden PQR text: the codec's records equal
    the Python path's and the JAX package's, and the state they build
    formats to the same bytes through the codec, the Python path and the
    JAX package's native codec."""
    text = _text(source)
    kw = dict(is_text=True, scale_charge=0.5)
    via_codec = pqr_t.read_pqr(text, **kw)
    with monkeypatch.context() as m:
        _python_path(m)
        via_python = pqr_t.read_pqr(text, **kw)
    via_jax = pqr_j.read_pqr(text, **kw)
    assert via_codec == via_python
    assert [vars(a) for a in via_codec] == [vars(a) for a in via_jax]
    basis = np.eye(3) * 30.0
    out = _formats(via_codec, via_jax, basis, monkeypatch)
    assert out["codec"] == out["python"] == out["jax"]


@pytest.mark.parametrize("source", ATOM_GOLDENS,
                         ids=lambda p: os.path.basename(p))
def test_golden_atom_tables_format_match(source, monkeypatch):
    """The goldens' atom tables (every force field's parameters, the
    wide-box extended format where the basis reaches 100 A): the same
    bytes through the codec, the Python path and the JAX codec, and the
    codec reads its own output back to the same records as Python."""
    fix = _golden(source)
    # the atom-table recipe of tests/test_golden.py::build_from_fixture
    atoms_t, atoms_j = ([AtomRecord(
        atomtype=at, moleculetype=mt, molecule_id=mid, x=x, y=y, z=z,
        mass=mass, charge=q * E2REDUCED, polarizability=al, epsilon=eps,
        sigma=sig, omega=om, gwp_alpha=gw, c6=c6, c8=c8, c10=c10, c9=c9)
        for (at, mt, mid, x, y, z, mass, q, al, eps, sig, om, gw, c6, c8,
             c10, c9) in fix["atoms"]]
        for AtomRecord in (AtomRecord_t, AtomRecord_j))
    basis = np.eye(3) * fix["basis"]
    out = _formats(atoms_t, atoms_j, basis, monkeypatch)
    assert out["codec"] == out["python"] == out["jax"]
    for text in out["codec"]:
        back = pqr_t.read_pqr(text, is_text=True)
        with monkeypatch.context() as m:
            _python_path(m)
            assert back == pqr_t.read_pqr(text, is_text=True)


def test_async_write_rotates_last_and_drains(tmp_path):
    """Two restart writes to one path through the writer thread: after
    ``drain()`` the path holds the second text and ``.last`` the first,
    as the synchronous Python path leaves them; no write failed."""
    path = str(tmp_path / "job.restart.pqr")
    errors = native_t.async_errors()
    texts = [f"REMARK frame {i}\n" * 2000 for i in range(2)]
    for text in texts:
        pqr_t.write_pqr_with_rotation(path, text)
    pqr_t.drain()
    with open(path) as f:
        assert f.read() == texts[1]
    with open(path + ".last") as f:
        assert f.read() == texts[0]
    assert native_t.async_errors() == errors
    pqr_t.write_pqr_with_rotation("/dev/null", "x")
    pqr_t.drain()


def test_library_lives_under_the_port():
    """The codec the port loads is its own build under
    mpmcxx_tpu_torch/_build/, keyed by a hash of its source, never the
    JAX package's runtime/libmpmcio.so; the source is the port's copy."""
    lib = native_t.get_lib()
    path = native_t.lib_path()
    assert lib._name == path and os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "mpmcxx_tpu_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("libmpmcio_")
    assert native_t._SRC == os.path.join(REPO, "mpmcxx_tpu_torch",
                                         "runtime", "mpmcio.cpp")
    with open("/proc/self/maps") as f:
        assert path in f.read()


def _fresh_loader(monkeypatch, tmp_path):
    """The loader as on a machine where nothing was built yet."""
    monkeypatch.setattr(native_t, "_lib", None)
    monkeypatch.setattr(native_t, "_tried", False)
    monkeypatch.setattr(native_t, "_BUILD", str(tmp_path / "_build"))


def test_without_gxx_python_path_writes_same_bytes(tmp_path, monkeypatch,
                                                   capfd):
    """With no g++ on PATH and no library built, the writer and the codec
    take the Python path, one line on stderr says so, and the bytes on
    disk equal the codec's."""
    src = os.path.join(REPO, "examples", "gcmc-mof-co2", "mof_co2.pqr")
    st, meta = build_t(pqr_t.read_pqr(src), np.eye(3) * 24.0,
                       extra_mol_capacity=4, device="cpu")
    with_codec = tmp_path / "codec.pqr"
    pqr_t.write_state_pqr(str(with_codec), st, meta)
    pqr_t.drain()
    _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert shutil.which("g++") is None
    capfd.readouterr()
    assert native_t.get_lib() is None
    assert "no g++" in capfd.readouterr().err
    no_codec = tmp_path / "python.pqr"
    pqr_t.write_state_pqr(str(no_codec), st, meta)
    pqr_t.write_state_pqr(str(no_codec), st, meta)
    assert (tmp_path / "python.pqr.last").exists()
    assert no_codec.read_bytes() == with_codec.read_bytes()
    assert pqr_t.read_pqr(str(no_codec)) == pqr_t.read_pqr(str(with_codec))


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A source that g++ refuses raises with the compiler's output; the
    loader does not fall back to Python quietly."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the Python path is taken")
    bad = tmp_path / "mpmcio.cpp"
    bad.write_text("this is not C++\n")
    _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setattr(native_t, "_SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_t.get_lib()
    assert not os.listdir(tmp_path / "_build")
