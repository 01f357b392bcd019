from setuptools import find_packages, setup

setup(
    name="gsworld_tpu",
    version="0.1.0",
    description=(
        "TPU-native closed-loop photorealistic simulation engine for robotic "
        "manipulation (JAX/XLA/Pallas)"
    ),
    packages=find_packages(include=["gsworld_tpu", "gsworld_tpu.*",
                                    "gsworld_tpu_torch",
                                    "gsworld_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy"],
    include_package_data=True,
    package_data={"gsworld_tpu": ["assets/**/*.json", "assets/**/*.npz"],
                  "gsworld_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
)
