"""Host data built once per test run and shared by the xdist workers."""

import os
import pickle

from filelock import FileLock, Timeout


def _path(tmp_path_factory, name):
    return tmp_path_factory.getbasetemp().parent / f"{name}.pkl"


def _load_or_build(path, build):
    """Under the caller's lock on ``path``."""
    if path.is_file():
        return pickle.loads(path.read_bytes())
    ref = build()
    path.write_bytes(pickle.dumps(ref))
    return ref


def built_once(tmp_path_factory, name, build):
    """``build()`` (host data) once per test run: under xdist the first
    worker to ask builds it under a file lock in the run's shared
    temporary directory and the others read it."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return build()
    path = _path(tmp_path_factory, name)
    with FileLock(str(path) + ".lock"):
        return _load_or_build(path, build)


def built_once_all(tmp_path_factory, builds):
    """``{name: build}`` -> ``{name: built}``, each as :func:`built_once`;
    a worker first takes the builds no other worker holds, then waits for
    the ones another is building, so two workers that ask at once build
    two halves side by side."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return {name: build() for name, build in builds.items()}
    out, held = {}, []
    for name, build in builds.items():
        path = _path(tmp_path_factory, name)
        try:
            with FileLock(str(path) + ".lock", timeout=0):
                out[name] = _load_or_build(path, build)
        except Timeout:
            held.append(name)
    for name in held:
        out[name] = built_once(tmp_path_factory, name, builds[name])
    return out
