from setuptools import find_packages, setup

setup(
    name="deeplearning4j-tpu",
    version="0.1.0",
    description="TPU-native deep-learning framework with the capability surface of Deeplearning4j",
    packages=find_packages(include=["deeplearning4j_tpu", "deeplearning4j_tpu.*",
                                    "deeplearning4j_tpu_torch", "deeplearning4j_tpu_torch.*"]),
    # the port's CUDA sources, compiled with nvcc at first use
    package_data={"deeplearning4j_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    # jax/flax/optax/numpy are provided by the environment; no pinned deps here
)
