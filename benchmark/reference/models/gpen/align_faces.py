"""GPEN's 5-point face alignment: the Umeyama similarity and the
reference points. The warps themselves are ``ops/warp.py::affine_warp``."""

from __future__ import annotations

import numpy as np

REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.3655014],
    [62.72990036, 92.20410156],
])
DEFAULT_CROP_SIZE = (96, 112)


def umeyama(src, dst, estimate_scale=True, scale=1.0):
    """Least-squares similarity transform src -> dst (Umeyama 1991):
    returns ([3,3] homogeneous matrix, scale)."""
    num, dim = src.shape
    src_mean, dst_mean = src.mean(axis=0), dst.mean(axis=0)
    src_demean, dst_demean = src - src_mean, dst - dst_mean
    A = dst_demean.T @ src_demean / num
    d = np.ones((dim,), dtype=np.double)
    if np.linalg.det(A) < 0:
        d[dim - 1] = -1
    T = np.eye(dim + 1, dtype=np.double)
    U, S, V = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return np.nan * T, scale
    if rank == dim - 1:
        if np.linalg.det(U) * np.linalg.det(V) > 0:
            T[:dim, :dim] = U @ V
        else:
            s = d[dim - 1]
            d[dim - 1] = -1
            T[:dim, :dim] = U @ np.diag(d) @ V
            d[dim - 1] = s
    else:
        T[:dim, :dim] = U @ np.diag(d) @ V
    if estimate_scale:
        scale = 1.0 / src_demean.var(axis=0).sum() * (S @ d)
    T[:dim, dim] = dst_mean - scale * (T[:dim, :dim] @ src_mean.T)
    T[:dim, :dim] *= scale
    return T, scale


def get_reference_facial_points(output_size=None, inner_padding_factor=0.0,
                                outer_padding=(0, 0), default_square=False):
    """The five reference points for a crop of ``output_size``."""
    tmp_5pts = np.array(REFERENCE_FACIAL_POINTS)
    tmp_crop_size = np.array(DEFAULT_CROP_SIZE)
    if default_square:
        size_diff = max(tmp_crop_size) - tmp_crop_size
        tmp_5pts += size_diff / 2
        tmp_crop_size = tmp_crop_size + size_diff
    if (output_size and output_size[0] == tmp_crop_size[0]
            and output_size[1] == tmp_crop_size[1]):
        return tmp_5pts
    if inner_padding_factor == 0 and outer_padding == (0, 0):
        if output_size is None:
            return tmp_5pts
        raise ValueError(f"output_size must be None or {tmp_crop_size}")
    if not 0 <= inner_padding_factor <= 1.0:
        raise ValueError("inner_padding_factor out of range")
    if inner_padding_factor > 0:
        size_diff = tmp_crop_size * inner_padding_factor * 2
        tmp_5pts += size_diff / 2
        tmp_crop_size = tmp_crop_size + np.round(size_diff).astype(np.int32)
    size_bf_outer_pad = np.array(output_size) - np.array(outer_padding) * 2
    if size_bf_outer_pad[0] * tmp_crop_size[1] != size_bf_outer_pad[1] * tmp_crop_size[0]:
        raise ValueError("output/crop aspect mismatch")
    scale_factor = size_bf_outer_pad[0].astype(np.float32) / tmp_crop_size[0]
    return tmp_5pts * scale_factor + np.array(outer_padding)


def similarity_pair(facial5points, reference_pts):
    """The crop transform (image -> crop) and its Umeyama inverse (crop ->
    image) for five landmarks [2,5] or [5,2], as the reference's
    ``warp_and_crop_face`` fits them. Returns two [2,3] matrices."""
    ref_pts = np.float32(reference_pts)
    if ref_pts.shape[0] == 2:
        ref_pts = ref_pts.T
    src_pts = np.float32(facial5points)
    if src_pts.shape[0] == 2:
        src_pts = src_pts.T
    params, scale = umeyama(src_pts, ref_pts)
    params_inv, _ = umeyama(ref_pts, src_pts, False, scale=1.0 / scale)
    return params[:2, :], params_inv[:2, :]


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a [2,3] matrix, as float32."""
    Ainv = np.linalg.inv(m[:, :2])
    return np.concatenate([Ainv, (-Ainv @ m[:, 2])[:, None]], axis=1).astype(np.float32)
