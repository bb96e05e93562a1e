"""FFHQ-style face crop and alignment on the host, with the inverse
perspective that pastes a result back (counterpart of
``e4s_tpu/utils/alignment.py``). Landmarks come from dlib when it is
installed, or are given by the caller (68 points per image), which needs no
dlib.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def landmarks_to_transform(lm: np.ndarray, scale: float = 1.0):
    """68-point landmarks -> oriented crop frame (c, x, y)."""
    lm = np.asarray(lm, dtype=np.float64)
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    lm_mouth_outer = lm[48:60]

    eye_left = np.mean(lm_eye_left, axis=0)
    eye_right = np.mean(lm_eye_right, axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_left = lm_mouth_outer[0]
    mouth_right = lm_mouth_outer[6]
    mouth_avg = (mouth_left + mouth_right) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    x *= scale
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    return c, x, y


def get_landmark(filepath_or_image, predictor=None, detector=None):
    """dlib 68-landmark detection; None when no face is found."""
    try:
        import dlib
    except ImportError as e:
        raise ImportError(
            "dlib is required for landmark detection (need_crop=True); install "
            "it or pass precomputed landmarks / use need_crop=False"
        ) from e
    from PIL import Image

    if detector is None:
        detector = dlib.get_frontal_face_detector()
    if isinstance(filepath_or_image, Image.Image):
        img = np.array(filepath_or_image)
    else:
        img = dlib.load_rgb_image(filepath_or_image)
    dets = detector(img)
    for d in dets:
        shape = predictor(img, d)
        return np.array([[p.x, p.y] for p in shape.parts()])
    return None


def crop_image(filepath_or_image, output_size: int, quad: np.ndarray):
    """Shrink -> crop -> QUAD-transform to output_size^2 (no padding)."""
    import PIL.Image

    quad = np.asarray(quad, dtype=np.float64).copy()
    x = (quad[3] - quad[1]) / 2
    qsize = np.hypot(*x) * 2
    img = (
        filepath_or_image
        if isinstance(filepath_or_image, PIL.Image.Image)
        else PIL.Image.open(filepath_or_image)
    )
    transform_size = output_size
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (
            int(np.rint(float(img.size[0]) / shrink)),
            int(np.rint(float(img.size[1]) / shrink)),
        )
        img = img.resize(rsize, PIL.Image.LANCZOS)
        quad /= shrink
        qsize /= shrink
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (
        int(np.floor(min(quad[:, 0]))),
        int(np.floor(min(quad[:, 1]))),
        int(np.ceil(max(quad[:, 0]))),
        int(np.ceil(max(quad[:, 1]))),
    )
    crop = (
        max(crop[0] - border, 0),
        max(crop[1] - border, 0),
        min(crop[2] + border, img.size[0]),
        min(crop[3] + border, img.size[1]),
    )
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]
    img = img.transform(
        (transform_size, transform_size),
        PIL.Image.QUAD,
        (quad + 0.5).flatten(),
        PIL.Image.BILINEAR,
    )
    if output_size < transform_size:
        img = img.resize((output_size, output_size), PIL.Image.LANCZOS)
    return img


def crop_faces(
    image_size: int,
    files: Sequence[Tuple[str, str]],
    scale: float,
    center_sigma: float = 0.0,
    xy_sigma: float = 0.0,
    use_fa: bool = False,
    predictor_path: str = "./pretrained_ckpts/shape_predictor_68_face_landmarks.dat",
    landmarks: Optional[Sequence[np.ndarray]] = None,
):
    """Crops of ``files`` ((name, path) pairs), with optional temporal
    smoothing of the crop quads. ``landmarks`` bypasses dlib."""
    from scipy.ndimage import gaussian_filter1d

    cs, xs, ys = [], [], []
    if landmarks is not None:
        for lm in landmarks:
            c, x, y = landmarks_to_transform(lm, scale)
            cs.append(c); xs.append(x); ys.append(y)
    else:
        import dlib

        predictor = dlib.shape_predictor(predictor_path)
        detector = dlib.get_frontal_face_detector()
        for _, path in files:
            lm = get_landmark(path, predictor, detector)
            if lm is None:
                raise RuntimeError(f"Did not detect any faces in image: {path}")
            c, x, y = landmarks_to_transform(lm, scale)
            cs.append(c); xs.append(x); ys.append(y)

    cs, xs, ys = np.stack(cs), np.stack(xs), np.stack(ys)
    if center_sigma != 0:
        cs = gaussian_filter1d(cs, sigma=center_sigma, axis=0)
    if xy_sigma != 0:
        xs = gaussian_filter1d(xs, sigma=xy_sigma, axis=0)
        ys = gaussian_filter1d(ys, sigma=xy_sigma, axis=0)

    quads = np.stack([cs - xs - ys, cs - xs + ys, cs + xs + ys, cs + xs - ys], axis=1)
    quads = list(quads)

    from PIL import Image

    crops, orig_images = [], []
    for quad, (_, path) in zip(quads, files):
        crops.append(crop_image(path, image_size, quad.copy()))
        orig_images.append(Image.open(path))
    return crops, orig_images, quads


def calc_alignment_coefficients(pa, pb) -> np.ndarray:
    """8-dof perspective coefficients mapping pb -> pa (for PIL transform)."""
    matrix = []
    for p1, p2 in zip(pa, pb):
        matrix.append([p1[0], p1[1], 1, 0, 0, 0, -p2[0] * p1[0], -p2[0] * p1[1]])
        matrix.append([0, 0, 0, p1[0], p1[1], 1, -p2[1] * p1[0], -p2[1] * p1[1]])
    a = np.asarray(matrix, dtype=float)
    b = np.asarray(pb, dtype=float).reshape(8)
    res = np.linalg.solve(a.T @ a, a.T @ b)
    return res.reshape(8)


def crop_and_align_face(target_files, image_size: int = 1024, scale: float = 1.0,
                        center_sigma: float = 0.0, xy_sigma: float = 0.0,
                        use_fa: bool = False, landmarks=None):
    """Returns (crops, original images, quads, inverse transforms): the
    perspective coefficients that map each crop back into its original."""
    crops, orig_images, quads = crop_faces(
        image_size, target_files, scale,
        center_sigma=center_sigma, xy_sigma=xy_sigma, use_fa=use_fa,
        landmarks=landmarks,
    )
    inv_transforms = [
        calc_alignment_coefficients(
            quad + 0.5,
            [[0, 0], [0, image_size], [image_size, image_size], [image_size, 0]],
        )
        for quad in quads
    ]
    return crops, orig_images, quads, inv_transforms
