"""PyTorch port: the image scrapers (foodrec_tpu_torch.data.scrapers)
against the JAX package's (foodrec_tpu.data.scrapers), offline: URL
extraction, the pending list with its skip-list, and download_images with
injected fetchers, with 1 worker and with 2 (the port's pool spawns its
workers, so the fakes live at module level and this module imports
nothing heavy at its top)."""

import functools
import os

import pytest

from foodrec_tpu_torch.data import scrapers

HTML = """
<html><body>
<img src="https://cdn.example.com/banner.png">
<div class="wrap primary-image extra"><a><img alt="x"
 src="https://img.example.com/recipe-123.jpg?w=960"></a></div>
<img src="https://cdn.example.com/other.jpg">
</body></html>
"""
PAGES = {"u3": HTML, "u4": "<html>nothing</html>", "u5": None,
         "u6": '<img src="https://x/y6.jpeg">', "u7": HTML}


def fake_page(url):
    if PAGES[url] is None:
        raise OSError("timeout")
    return PAGES[url]


def fake_image(url):
    return f"JPEG:{url}".encode()


def _jax():
    from foodrec_tpu.data import scrapers as jscrapers

    return jscrapers


@pytest.mark.parametrize("html", [
    HTML, '<img src="https://x/y.jpg">', "<html></html>",
    '<div class="primary-image"><img src="a.JPG"></div><img src="b.jpg">',
    '<img src="c.png"><img src="d.jpeg?x=1">'])
def test_extract_primary_image_url_matches_jax(html):
    got = scrapers.extract_primary_image_url(html)
    assert got == _jax().extract_primary_image_url(html)
    if html is HTML:
        assert got == "https://img.example.com/recipe-123.jpg?w=960"


def test_pending_and_skip_list_match_jax(tmp_path):
    out = tmp_path / "imgs"
    out.mkdir()
    (out / "1.jpg").write_bytes(b"x")
    skip = tmp_path / "no_image.txt"
    skip.write_text("2\n\n 5 \n")
    items = [(1, "u1"), (2, "u2"), (3, "u3"), (5, "u5"), (6, "u6")]
    got = scrapers.pending_items(items, str(out), str(skip))
    assert got == _jax().pending_items(items, str(out), str(skip))
    assert got == [(3, "u3"), (6, "u6")]
    assert scrapers.load_skip_list(str(skip)) == {"2", "5"}
    assert scrapers.load_skip_list(str(tmp_path / "absent.txt")) == set()
    assert scrapers.pending_items(items, str(out)) == items[1:]


def _tree(root):
    return {n: (root / n).read_bytes() for n in sorted(os.listdir(root))}


@pytest.mark.parametrize("workers", [1, 2])
def test_download_images_offline_matches_jax(tmp_path, workers):
    items = [(3, "u3"), (4, "u4"), (5, "u5"), (6, "u6"), (7, "u7")]
    results, trees = [], []
    for name, mod in (("port", scrapers), ("jax", _jax())):
        out, skip = tmp_path / name / "imgs", tmp_path / name / "skip.txt"
        dl = functools.partial(mod.download_one, fetch_page=fake_page,
                               fetch_image=fake_image)
        res = mod.download_images(items, str(out), str(skip),
                                  workers=workers, download=dl)
        # resume: nothing left for the downloaded and the skipped
        again = mod.download_images(items, str(out), str(skip),
                                    workers=workers, download=dl)
        results.append((res, again, skip.read_text()))
        trees.append(_tree(out))
    assert results[0] == results[1] and trees[0] == trees[1]
    res, again, skipped = results[0]
    assert res == {"ok": [3, 6, 7], "no_image": [4], "error": [5]}
    assert again == {"ok": [], "no_image": [], "error": [5]}
    assert skipped == "4\n"
    assert trees[0]["6.jpg"] == b"JPEG:https://x/y6.jpeg"
