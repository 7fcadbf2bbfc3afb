"""The benchmark's own tests: ``python -m pytest capbench/tests -q`` from the
repository's root.  Tests marked ``cuda`` need an NVIDIA card and skip
without one; on a card: ``python -m pytest -m cuda capbench/tests -q``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


TINY = dict(dim_embedding=16, num_lstm_units=16, dim_attend_layer=16, dim_decode_layer=32, fc_kernel_initializer_scale=0.5,
            dim_initialize_layer=16, vocabulary_size=500, max_caption_length=20)


def tiny_cell(name: str, **config):
    """The cell as BENCHMARK.json names it, its widths cut to a size the CPU
    runs in seconds (the CNN's own widths stay: VGG16 at 32 px, ResNet50
    at 64 px)."""
    from capbench import bench

    cell = bench.load_cell(name)
    size = 32 if cell.config["cnn"] == "vgg16" else 64
    stride = 16 if cell.config["cnn"] == "vgg16" else 32
    cell.config.update(TINY, image_size=size, num_ctx=(size // stride) ** 2, **config)
    if cell.traffic["driver"] == "offline":
        cell.traffic.update(batch=8, ring=2, warm_batches=1, check_images=8)
    else:
        cell.traffic.update(batch=8, min_words=2, max_words=4)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
