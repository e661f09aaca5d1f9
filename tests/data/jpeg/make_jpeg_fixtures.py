"""Write the JPEG fixtures of this folder with OpenCV and record the sha1
of OpenCV's decode of each (``fixtures.json``).

    python tests/data/jpeg/make_jpeg_fixtures.py

* ``texture_2048.jpg``: a seeded 2048x2048 colour field (smooth sines
  and a little noise, like a scan's diffuse atlas), baseline, 4:2:0,
  quality 90, a restart marker every 64 MCUs: the texture of
  ``chip_smoke.py``'s RenderPeople scan.
* ``progressive_256.jpg``: a seeded 256x256 colour field, progressive,
  4:4:4, quality 95.

The sha1 is of ``cv2.imread(path, cv2.IMREAD_COLOR).tobytes()`` (BGR,
row-major); the port's ``imread_checked`` must give the same bytes.  The
machine with the card has no JPEG encoder or decoder but the port's, so
these files are committed.
"""

import hashlib
import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = {
    "texture_2048.jpg": dict(size=2048, seed=0, params=[
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 64]),
    "progressive_256.jpg": dict(size=256, seed=1, params=[
        cv2.IMWRITE_JPEG_QUALITY, 95,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
}


def colour_field(size: int, seed: int) -> np.ndarray:
    """uint8 ``[size, size, 3]`` RGB: per channel a sum of three seeded
    sines over the image plane, plus noise of 3 levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size
    img = np.empty((size, size, 3))
    for c in range(3):
        f = rng.uniform(2.0, 12.0, size=(3, 2))
        ph = rng.uniform(0.0, 2 * np.pi, size=3)
        img[..., c] = 128 + sum(
            40 * np.sin(2 * np.pi * (f[k, 0] * xx + f[k, 1] * yy) + ph[k])
            for k in range(3))
    img += rng.normal(0.0, 3.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main():
    record = {}
    for name, spec in FIXTURES.items():
        path = os.path.join(HERE, name)
        rgb = colour_field(spec["size"], spec["seed"])
        assert cv2.imwrite(path, rgb[..., ::-1], spec["params"])
        dec = cv2.imread(path, cv2.IMREAD_COLOR)
        record[name] = dict(shape=list(dec.shape),
                            sha1=hashlib.sha1(dec.tobytes()).hexdigest(),
                            bytes=os.path.getsize(path))
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
