"""The port's storage initializer (``serving/storage.py``) against the JAX
package's: every case of ``tests/test_storage_schemes.py`` runs on both
packages' ``pull_model`` over one file-backed object-store emulator and
one PVC root (set with monkeypatch), and the pulled trees, the pull cache's
behaviour, and the error types and messages must be equal.
"""

import json
import threading

import pytest

from kubeflow_tpu.serving import storage as jstorage
from kubeflow_tpu_torch.serving import storage as tstorage
from kubeflow_tpu_torch.utils import envvars

PACKAGES = {"jax": jstorage, "port": tstorage}


def tree(dest):
    """{relative path: bytes} of a pulled dir (the pull manifest parsed)."""
    out = {}
    for p in sorted(dest.rglob("*")):
        if p.is_file():
            rel = p.relative_to(dest).as_posix()
            data = p.read_bytes()
            if p.name == tstorage.MANIFEST_FILE:
                data = json.loads(data)
                data["objects"] = sorted(data["objects"])
            out[rel] = data
    return out


@pytest.fixture()
def emulator(tmp_path, monkeypatch):
    root = tmp_path / "object-store"
    for scheme, bucket in (("gs", "ml-models"), ("s3", "ml-models"),
                           ("hf", "my-org")):
        base = root / scheme / bucket / "bert"
        (base / "weights").mkdir(parents=True)
        (base / "config.json").write_text(json.dumps({"scheme": scheme}))
        (base / "weights" / "part-0.bin").write_bytes(b"\x00" * 64)
    monkeypatch.setenv(tstorage.EMULATOR_ENV, str(root))
    return root


def pull_both(tmp_path, uri, tag="dest"):
    """Pull `uri` with both packages into their own dests -> their trees,
    or the (type, message) each raised."""
    out = {}
    for name, mod in PACKAGES.items():
        try:
            out[name] = tree(mod.pull_model(uri, tmp_path / name / tag))
        except Exception as exc:  # noqa: BLE001 — compared below
            out[name] = (type(exc), str(exc))
    return out


def test_env_names_and_constants_equal_jax():
    assert tstorage.EMULATOR_ENV == jstorage.EMULATOR_ENV \
        == envvars.ENV_OBJECT_STORE_EMULATOR
    assert tstorage.PVC_ROOT_ENV == jstorage.PVC_ROOT_ENV \
        == envvars.ENV_PVC_ROOT
    assert tstorage.MANIFEST_FILE == jstorage.MANIFEST_FILE
    assert tstorage.DEFAULT_PVC_ROOT == jstorage.DEFAULT_PVC_ROOT


@pytest.mark.parametrize("uri", [
    "gs://ml-models/bert", "s3://ml-models/bert", "hf://my-org/bert",
    "gs://ml-models/bert/config.json",   # a single object
    "gs://ml-models/ghost",              # no such prefix
    "s3://no-such-bucket/bert",          # no such bucket
    "gs://../gs/ml-models",              # bucket traversal
    "gs://ml-models/../secrets",         # key traversal
    "gs:///bert",                        # no bucket
])
def test_remote_pull_equal_jax(uri, emulator, tmp_path):
    got = pull_both(tmp_path, uri)
    assert got["port"] == got["jax"], uri
    if isinstance(got["port"], dict):
        assert "config.json" in got["port"]
    else:
        assert uri.endswith(("ghost", "bert", "ml-models", "secrets"))


def test_prefix_respects_key_boundaries(emulator, tmp_path):
    other = emulator / "gs" / "ml-models" / "bert2"
    other.mkdir()
    (other / "decoy.txt").write_text("x")
    got = pull_both(tmp_path, "gs://ml-models/bert")
    assert got["port"] == got["jax"] and "decoy.txt" not in got["port"]


@pytest.mark.parametrize("change", ["none", "size", "delete", "torn",
                                    "uri-switch", "local-first"])
def test_pull_cache_equal_jax(change, emulator, tmp_path):
    """Re-pulls after a change to the source or the dest: the cache skips
    unchanged objects (a local edit survives), refetches changed ones,
    drops deleted ones even past a torn manifest (which refetches
    everything), refetches all on a uri switch, and replaces a dest a
    local pull made."""
    src = emulator / "gs" / "ml-models" / "bert"
    results = {}
    for name, mod in PACKAGES.items():
        dest = tmp_path / name
        if change == "local-first":
            local = tmp_path / "local-model"
            local.mkdir(exist_ok=True)
            (local / "stale-artifact.bin").write_bytes(b"old")
            mod.pull_model(f"file://{local}", dest)
        mod.pull_model("gs://ml-models/bert", dest)
        (dest / "weights" / "part-0.bin").write_bytes(b"LOCAL-EDIT")
        uri = "gs://ml-models/bert"
        if change == "size":
            (src / "weights" / "part-0.bin").write_bytes(b"\xff" * 128)
        elif change == "delete":
            (src / "config.json").unlink()
        elif change == "torn":
            (src / "config.json").unlink()
            (dest / tstorage.MANIFEST_FILE).write_text("{torn")
        elif change == "uri-switch":
            import shutil

            v2 = emulator / "gs" / "ml-models" / "bert-v2"
            if not v2.exists():
                shutil.copytree(src, v2, copy_function=shutil.copy2)
            uri = "gs://ml-models/bert-v2"
        mod.pull_model(uri, dest)
        results[name] = tree(dest)
        # put the source back for the other package
        (src / "weights" / "part-0.bin").write_bytes(b"\x00" * 64)
        (src / "config.json").write_text(json.dumps({"scheme": "gs"}))
    assert results["port"] == results["jax"]
    part = results["port"]["weights/part-0.bin"]
    assert part == (b"LOCAL-EDIT" if change in ("none", "delete",
                                                "local-first")
                    else b"\xff" * 128 if change == "size" else b"\x00" * 64)
    assert ("config.json" in results["port"]) == (change not in ("delete",
                                                                 "torn"))
    assert "stale-artifact.bin" not in results["port"]


def test_local_schemes_equal_jax(tmp_path, monkeypatch):
    pvc = tmp_path / "pvc"
    (pvc / "vol" / "m" / "sub").mkdir(parents=True)
    (pvc / "vol" / "m" / "config.json").write_text("{}")
    (pvc / "vol" / "m" / "sub" / "w.bin").write_bytes(b"\x01\x02")
    monkeypatch.setenv(tstorage.PVC_ROOT_ENV, str(pvc))
    for uri in ("pvc://vol/m", f"file://{pvc}/vol/m", str(pvc / "vol" / "m"),
                f"file://{pvc}/vol/m/config.json", "pvc://vol/missing"):
        got = pull_both(tmp_path, uri)
        assert got["port"] == got["jax"], uri
    assert tstorage.resolve_uri("pvc://vol/m") == pvc / "vol" / "m"
    with pytest.raises(RuntimeError, match="no local path"):
        tstorage.resolve_uri("gs://b/m")


def test_egress_gate_equal_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(tstorage.EMULATOR_ENV, raising=False)
    for uri in ("gs://bucket/model", "hf://org/model",
                "https://host/model"):
        got = pull_both(tmp_path, uri)
        assert got["port"] == got["jax"], uri
        kind, message = got["port"]
        assert kind is RuntimeError and "network egress" in message
        assert tstorage.EMULATOR_ENV in message


def test_concurrent_pulls_same_dest_are_safe(emulator, tmp_path):
    errs = []

    def pull():
        try:
            tstorage.pull_model("gs://ml-models/bert", tmp_path / "dest")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=pull) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    assert (tmp_path / "dest" / "weights" / "part-0.bin").exists()
