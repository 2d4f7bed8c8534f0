from setuptools import find_packages, setup

setup(
    name="rrmpg-jax",
    version="0.5.0",
    description=("Rainfall-runoff modeling framework for accelerators "
                 "(JAX / XLA / Pallas)"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    python_requires=">=3.11",
    packages=find_packages(exclude=["tests", "benchmarks"]),
    package_data={
        "rrmpg_jax.data": ["camels/*.txt"],
        "rrmpg_jax.native": ["oracle.cpp"],
    },
    include_package_data=True,
    install_requires=[
        "jax",
        "numpy",
        "scipy",
        "optax",
    ],
    extras_require={
        "data": ["pandas"],
        "plot": ["matplotlib", "pandas"],
        "test": ["pytest", "scipy"],
        "multihost": ["orbax-checkpoint"],
    },
)
