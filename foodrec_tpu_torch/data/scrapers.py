# coding: utf-8
"""Image scrapers, host only (reference: dataset_process/download_image.py:
46-117 and download_check.py:34-145; counterpart of
`foodrec_tpu/data/scrapers.py`, the same functions and results):
multiprocessing food.com page scrape — the
`primary-image` div's jpg is downloaded per recipe with a socket timeout, a
`no_image.txt` skip-list, resumable re-check passes, and default-image
flagging.

Network I/O is isolated behind `fetch_html` / `fetch_binary` so the parsing
and resume logic is testable offline. The pool's workers are spawned, so
`download` must be a module-level function.
"""

import multiprocessing
import os
import re
import socket
import urllib.request

DEFAULT_TIMEOUT_S = 45
DEFAULT_WORKERS = 60

# the reference scrapes the div with class "primary-image" and takes its
# <img src=...jpg> (download_image.py)
_PRIMARY_IMG_RE = re.compile(
    r'class="[^"]*primary-image[^"]*"[^>]*>.*?<img[^>]+src="([^"]+?\.jpe?g[^"]*)"',
    re.S | re.I)
_ANY_IMG_RE = re.compile(r'<img[^>]+src="([^"]+?\.jpe?g[^"]*)"', re.I)


def fetch_html(url, timeout=DEFAULT_TIMEOUT_S):
    socket.setdefaulttimeout(timeout)
    with urllib.request.urlopen(url) as r:
        return r.read().decode("utf-8", errors="replace")


def fetch_binary(url, timeout=DEFAULT_TIMEOUT_S):
    socket.setdefaulttimeout(timeout)
    with urllib.request.urlopen(url) as r:
        return r.read()


def extract_primary_image_url(html):
    """First jpg inside the primary-image div; falls back to the page's
    first jpg (download_image.py's BeautifulSoup find equivalent)."""
    m = _PRIMARY_IMG_RE.search(html)
    if m:
        return m.group(1)
    m = _ANY_IMG_RE.search(html)
    return m.group(1) if m else None


def load_skip_list(no_image_path):
    """Recipe ids recorded as having no image (download_check.py:34-54)."""
    if not os.path.isfile(no_image_path):
        return set()
    with open(no_image_path) as f:
        return {line.strip() for line in f if line.strip()}


def pending_items(items, out_dir, no_image_path=None):
    """Resume support: items whose jpg is not yet on disk and that are not
    on the skip-list (download_check.py:86-127)."""
    skip = load_skip_list(no_image_path) if no_image_path else set()
    out = []
    for item_id, url in items:
        if str(item_id) in skip:
            continue
        if os.path.isfile(os.path.join(out_dir, f"{item_id}.jpg")):
            continue
        out.append((item_id, url))
    return out


def download_one(task, out_dir, fetch_page=fetch_html,
                 fetch_image=fetch_binary):
    """(item_id, page_url) -> ('ok'|'no_image'|'error', item_id).
    Per-item try/except keeps one bad page from killing the pool — the
    reference's only elastic-recovery pattern (SURVEY.md §5.3)."""
    item_id, url = task
    try:
        html = fetch_page(url)
        img_url = extract_primary_image_url(html)
        if not img_url:
            return ("no_image", item_id)
        data = fetch_image(img_url)
        with open(os.path.join(out_dir, f"{item_id}.jpg"), "wb") as f:
            f.write(data)
        return ("ok", item_id)
    except Exception:
        return ("error", item_id)


def download_images(items, out_dir, no_image_path=None,
                    workers=DEFAULT_WORKERS, download=download_one):
    """Multiprocessing scrape with resume + skip-list bookkeeping. Returns
    {'ok': [...], 'no_image': [...], 'error': [...]}."""
    os.makedirs(out_dir, exist_ok=True)
    todo = pending_items(items, out_dir, no_image_path)
    results = {"ok": [], "no_image": [], "error": []}
    if not todo:
        return results
    if workers <= 1:
        outcomes = [download(t, out_dir) for t in todo]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            outcomes = pool.starmap(download,
                                    [(t, out_dir) for t in todo])
    for status, item_id in outcomes:
        results[status].append(item_id)
    if no_image_path and results["no_image"]:
        with open(no_image_path, "a") as f:
            for item_id in results["no_image"]:
                f.write(f"{item_id}\n")
    return results
