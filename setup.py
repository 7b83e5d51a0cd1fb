from setuptools import find_packages, setup

setup(
    name="sisua_tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas) framework for semi-supervised "
                 "deep generative modeling of single-cell multi-omics data"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=("tests",)),
    package_data={"sisua_tpu": ["native/*.cpp"],
                  "sisua_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "pandas",
        "scikit-learn",
        "matplotlib",
        "seaborn",
        "pyyaml",
        "tqdm",
    ],
    extras_require={
        "export": ["anndata", "scvi-tools", "pyarrow"],
        "umap": ["umap-learn"],
    },
    scripts=["bin/sisua-train", "bin/sisua-analyze", "bin/sisua-embed",
             "bin/sisua-showdata", "bin/sisua-predict"],
    entry_points={
        "console_scripts": [
            "sisua-tpu-train=sisua_tpu.cli.train:main",
            "sisua-tpu-evaluate=sisua_tpu.cli.evaluate:main",
            "sisua-tpu-embed=sisua_tpu.label_threshold:main",
            "sisua-tpu-showdata=sisua_tpu.cli.showdata:main",
            "sisua-tpu-predict=sisua_tpu.cli.predict:main",
            "sisua-torch-train=sisua_tpu_torch.cli.train:main",
            "sisua-torch-predict=sisua_tpu_torch.cli.predict:main",
            "sisua-torch-evaluate=sisua_tpu_torch.cli.evaluate:main",
            "sisua-torch-embed=sisua_tpu_torch.label_threshold:main",
            "sisua-torch-showdata=sisua_tpu_torch.cli.showdata:main",
        ],
    },
    test_suite="tests",
)
