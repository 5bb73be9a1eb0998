"""Build: `python setup.py build_ext --inplace` compiles the native runtime.

The C++ extension accelerates host-side hot paths (audio decode, resample,
BPE encode, WER edit distance); every caller has a pure-Python fallback, so
the package works without building.
"""

from setuptools import Extension, find_packages, setup

setup(
    name="stac_st_tpu",
    version="0.1.0",
    description="TPU-native speech-translation framework (STAC-ST rebuild)",
    packages=find_packages(include=["stac_st_tpu", "stac_st_tpu.*",
                                    "stac_st_tpu_torch",
                                    "stac_st_tpu_torch.*"]),
    package_data={"stac_st_tpu_torch": ["csrc/*.cu"]},
    ext_modules=[
        Extension(
            "_stacnative",
            sources=["native/stacnative.cpp"],
            extra_compile_args=["-O3", "-std=c++17", "-fvisibility=hidden"],
        ),
        # in-process compressed-audio decode (mp3/ogg/flac/...) via the
        # system ffmpeg libraries; optional: skipped where the dev libs
        # are absent (Python falls back to CLI-tool auto-detection in
        # prep/audio_convert.py)
        Extension(
            "_stacaudio",
            sources=["native/stacaudio.cpp"],
            libraries=["avformat", "avcodec", "avutil", "swresample"],
            extra_compile_args=["-O3", "-std=c++17", "-fvisibility=hidden"],
            optional=True,
        ),
    ],
    python_requires=">=3.10",
)
