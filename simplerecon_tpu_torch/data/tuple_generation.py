"""Test/train tuple generation, host-side numpy and multiprocessing
(counterpart of `simplerecon_tpu/data/tuple_generation.py`, itself after
the reference's `data_scripts/generate_test_tuples.py` and
`generate_train_tuples.py`): crawl each scan's valid frames, run the DVMVS
keyframe policies, and emit tuple lines `scan_id f0 f1 ... fN-1` (f0 =
reference). Seeds are fixed (42) as in the reference so shipped
`data_splits` files can be reproduced exactly.

Test tuple types (`generate_test_tuples.py:26-41`):
  default        online keyframes (sources strictly in the past)
  offline        keyframes, sources both directions in time
  dense          online, a tuple for every frame
  dense_offline  offline, a tuple for every frame
"""

from __future__ import annotations

import os
import random
from functools import partial
from multiprocessing import Manager, Pool
from typing import Dict, List, Optional

import numpy as np

from simplerecon_tpu_torch.data.keyframe_buffer import (DVMVS_Config,
                                                  KeyframeBuffer,
                                                  OfflineKeyframeBuffer,
                                                  is_valid_pair)


def _test_buffer(cls, buffer_size=None):
    return cls(
        buffer_size=buffer_size or DVMVS_Config.test_keyframe_buffer_size,
        keyframe_pose_distance=DVMVS_Config.test_keyframe_pose_distance,
        optimal_t_score=DVMVS_Config.test_optimal_t_measure,
        optimal_R_score=DVMVS_Config.test_optimal_R_measure,
        store_return_indices=True)


def compute_offline_tuple(poses, n_measurement_frames, current_index,
                          reference_pose) -> Dict:
    """Offline tuple: walk outward alternating forward/backward
    (`generate_test_tuples.py:65-157`)."""
    sample = {"indices": [current_index]}
    buf = _test_buffer(OfflineKeyframeBuffer,
                       DVMVS_Config.test_keyframe_buffer_size * 2)
    buf.try_new_keyframe(reference_pose.copy(), None, index=current_index)

    back = current_index - 1
    fwd = current_index + 1
    direction = True
    count_added = 0
    exhausted_fwd = exhausted_back = False
    while not (exhausted_fwd and exhausted_back):
        if direction:
            direction = False
            if fwd >= len(poses):
                exhausted_fwd = True
                continue
            idx = fwd
            fwd += 1
        else:
            direction = True
            if back < 0:
                exhausted_back = True
                continue
            idx = back
            back -= 1
        if buf.try_new_keyframe(poses[idx].copy(), None, index=idx) == 1:
            count_added += 1
        if count_added >= DVMVS_Config.test_keyframe_buffer_size * 2:
            break

    for (_, _, idx) in buf.get_best_measurement_frames_for_0index(
            n_measurement_frames):
        sample["indices"].append(idx)
    return sample


def default_dvmvs_tuples(scan, poses, dists_to_last_valid,
                         n_measurement_frames) -> List[Dict]:
    """Online keyframe tuples (`generate_test_tuples.py:159-212`)."""
    buf = _test_buffer(KeyframeBuffer)
    samples = []
    for i in range(len(poses)):
        sample = {"scan": scan, "indices": [i]}
        response = buf.try_new_keyframe(poses[i].copy(), None,
                                        dists_to_last_valid[i], index=i)
        if response == 3:
            print("Tracking lost!")
        elif response == 1:
            for (_, _, idx) in buf.get_best_measurement_frames(
                    n_measurement_frames):
                sample["indices"].append(idx)
            samples.append(sample)
    return samples


def offline_dvmvs_tuples(scan, poses, n_measurement_frames) -> List[Dict]:
    """(`generate_test_tuples.py:214-266`)"""
    buf = _test_buffer(KeyframeBuffer)
    samples = []
    for i in range(len(poses)):
        if buf.try_new_keyframe(poses[i].copy(), None, index=i) != 1:
            continue
        sample = compute_offline_tuple(poses, n_measurement_frames, i,
                                       poses[i].copy())
        sample["scan"] = scan
        if len(sample["indices"]) == 1 and i == 0:
            continue
        samples.append(sample)
    return samples


def dense_dvmvs_tuples(scan, poses, n_measurement_frames) -> List[Dict]:
    """Online tuple for every frame (`generate_test_tuples.py:268-343`)."""
    samples = []
    for i in range(len(poses)):
        sample = {"scan": scan, "indices": [i]}
        buf = _test_buffer(OfflineKeyframeBuffer)
        buf.try_new_keyframe(poses[i], None, index=i)
        back = i - 1
        count_added = 0
        while back >= 0:
            if buf.try_new_keyframe(poses[back], None, index=back) == 1:
                count_added += 1
            back -= 1
            if count_added >= DVMVS_Config.test_keyframe_buffer_size:
                break
        for (_, _, idx) in buf.get_best_measurement_frames_for_0index(
                n_measurement_frames):
            sample["indices"].append(idx)
        if len(sample["indices"]) == 1 and i == 0:
            continue
        samples.append(sample)
    return samples


def dense_offline_dvmvs_tuples(scan, poses, n_measurement_frames
                               ) -> List[Dict]:
    """(`generate_test_tuples.py:345-382`)"""
    samples = []
    for i in range(len(poses)):
        sample = compute_offline_tuple(poses, n_measurement_frames, i,
                                       poses[i])
        sample["scan"] = scan
        if len(sample["indices"]) == 1 and i == 0:
            continue
        samples.append(sample)
    return samples


def pad_tuple(sampled_indices: List[int], subsequence_length: int
              ) -> List[int]:
    """Pads short tuples: sample unused recent frames, then repeat
    (`generate_test_tuples.py:480-515`)."""
    sampled_indices = list(sampled_indices)
    if len(sampled_indices) != subsequence_length:
        available = [i for i in range(sampled_indices[0])
                     if i not in sampled_indices]
        diff = min(subsequence_length - len(sampled_indices),
                   len(available))
        back = 30 if len(available) >= 30 else len(available)
        sampled_indices += random.sample(available[-back:], k=diff)
        if len(sampled_indices) != subsequence_length:
            diff = subsequence_length - len(sampled_indices)
            sampled_indices += random.choices(sampled_indices[1:], k=diff)
    assert len(sampled_indices) == subsequence_length
    return sampled_indices


def generate_test_tuples_for_scan(dataset, scan: str,
                                  frame_tuple_type: str,
                                  num_images_in_tuple: int) -> List[str]:
    """All tuple lines for one scan (`generate_test_tuples.py:384-528`)."""
    valid_frames = dataset.get_valid_frame_ids(dataset.split, scan)
    frame_ind_to_frame_id = {}
    dists_to_last_valid: List[Optional[int]] = []
    for ind, line in enumerate(valid_frames):
        parts = line.strip().split(" ")
        frame_ind_to_frame_id[ind] = parts[1]
        dists_to_last_valid.append(int(parts[2]) if len(parts) > 2
                                   else None)

    poses = [dataset.load_pose(scan.rstrip("\n"),
                               frame_ind_to_frame_id[i])[0]
             for i in range(len(valid_frames))]

    n_meas = num_images_in_tuple - 1
    if frame_tuple_type == "default":
        samples = default_dvmvs_tuples(scan, poses, dists_to_last_valid,
                                       n_meas)
    elif frame_tuple_type == "offline":
        samples = offline_dvmvs_tuples(scan, poses, n_meas)
    elif frame_tuple_type == "dense":
        samples = dense_dvmvs_tuples(scan, poses, n_meas)
    elif frame_tuple_type == "dense_offline":
        samples = dense_offline_dvmvs_tuples(scan, poses, n_meas)
    else:
        raise ValueError(f"unknown frame_tuple_type {frame_tuple_type!r}")

    lines = []
    for sample in samples:
        indices = pad_tuple(sample["indices"], num_images_in_tuple)
        ids = " ".join(str(frame_ind_to_frame_id[i]) for i in indices)
        lines.append(f"{scan} {ids}")
    return lines


# ------------------------------------------------------------------
# train tuples (`data_scripts/generate_train_tuples.py`)
# ------------------------------------------------------------------

def gather_pairs_train(poses, used_pairs, is_backward: bool,
                       initial_pose_dist_min: float,
                       initial_pose_dist_max: float) -> List:
    """Greedy 2-frame pairing with distance-loosening, an exact port of
    DVMVS's crawl (`generate_train_tuples.py:55-138`): walk the sequence
    from one end; for each reference i, first look backward (toward the
    walk origin), then forward; when nothing matches, loosen the
    distance window by 1.1x once before giving up on i."""
    sequence_length = len(poses)
    while_range = range(0, sequence_length)

    pose_dist_min = initial_pose_dist_min
    pose_dist_max = initial_pose_dist_max
    used_measurement_indices = set()

    check_future = False
    pairs = []

    if is_backward:
        i = sequence_length - 1
        step = -1
        first_limit = 5
        second_limit = sequence_length - 5
    else:
        i = 0
        step = 1
        first_limit = sequence_length - 5
        second_limit = 5

    loosening_counter = 0
    while i in while_range:
        pair = (i, -1)
        if check_future:
            candidates = range(i + step, first_limit, step)
        else:
            candidates = range(i - step, second_limit, -step)
        for j in candidates:
            if j in used_measurement_indices or (i, j) in used_pairs:
                continue
            if is_valid_pair(poses[i], poses[j], pose_dist_min,
                             pose_dist_max):
                pair = (i, j)
                pairs.append(pair)
                used_pairs.add(pair)
                used_pairs.add((j, i))
                used_measurement_indices.add(j)
                pose_dist_min = initial_pose_dist_min
                pose_dist_max = initial_pose_dist_max
                i += step
                check_future = False
                loosening_counter = 0
                break

        if pair[1] == -1:
            if check_future:
                pose_dist_min = pose_dist_min / 1.1
                pose_dist_max = pose_dist_max * 1.1
                check_future = False
                loosening_counter += 1
                if loosening_counter > 1:
                    i += step
                    loosening_counter = 0
            else:
                check_future = True
        else:
            check_future = False

    return pairs


# the reference's 10 crawl passes (`generate_train_tuples.py:291-300`):
# offsets cycle mod train_crawl_step, directions alternate, multipliers
# scale the DVMVS pose-distance window
_TRAIN_CRAWL_PASSES = [(0, 1.0, False), (1, 0.666, True), (2, 1.5, False),
                       (0, 0.8, True), (1, 1.25, False), (2, 1.0, True),
                       (0, 0.666, False), (1, 1.5, True), (2, 0.8, False),
                       (0, 1.25, True)]


def crawl_subsequences_train(poses, subsequence_length: int
                             ) -> List[List[int]]:
    """N-frame chain crawl, an exact port of DVMVS's
    `crawl_subprocess_long` (`generate_train_tuples.py:280-364`):
    10 (offset, multiplier, direction) passes; starts step by
    `train_crawl_step`; chains grow by walking outward one frame at a
    time from the start, accepting frames that pass node-usage,
    pair-reuse, and the multiplier-scaled pose-distance test (with
    t_norm_threshold = multiplier * dist_min * 0.5); chains that hit the
    sequence boundary before filling are discarded."""
    sequence_length = len(poses)
    used_pairs = set()
    usage_threshold = 1
    used_nodes = {i: 0 for i in range(sequence_length)}
    calculated_step = DVMVS_Config.train_crawl_step
    samples: List[List[int]] = []

    for offset, multiplier, is_backward in _TRAIN_CRAWL_PASSES:
        offset = offset % calculated_step
        if is_backward:
            start = sequence_length - 1 - offset
            step = -calculated_step
            limit = subsequence_length
        else:
            start = offset
            step = calculated_step
            limit = sequence_length - subsequence_length + 1

        dist_min = multiplier * DVMVS_Config.train_minimum_pose_distance
        dist_max = multiplier * DVMVS_Config.train_maximum_pose_distance
        t_thresh = multiplier * \
            DVMVS_Config.train_minimum_pose_distance * 0.5

        for i in range(start, limit, step):
            if used_nodes[i] > usage_threshold:
                continue
            indices = [i]
            previous_index = i
            valid_counter = 1
            any_counter = 1
            reached_sequence_limit = False
            while valid_counter < subsequence_length:
                j = i - any_counter if is_backward else i + any_counter
                reached_sequence_limit = (j < 0 if is_backward
                                          else j >= sequence_length)
                if reached_sequence_limit:
                    break
                if (used_nodes[j] <= usage_threshold
                        and (previous_index, j) not in used_pairs
                        and is_valid_pair(poses[previous_index], poses[j],
                                          dist_min, dist_max,
                                          t_norm_threshold=t_thresh)):
                    indices.append(j)
                    previous_index = j
                    valid_counter += 1
                any_counter += 1

            if not reached_sequence_limit:
                previous_node = indices[0]
                used_nodes[previous_node] += 1
                for current_node in indices[1:]:
                    used_nodes[current_node] += 1
                    used_pairs.add((previous_node, current_node))
                    used_pairs.add((current_node, previous_node))
                    previous_node = current_node
                samples.append(indices)
    return samples


def generate_train_tuples_for_scan(dataset, scan: str,
                                   num_images_in_tuple: int) -> List[str]:
    """Train tuples for one scan. The exported order is the chain order
    with the chain START first — frame_id_0 is the reference frame, as
    in the reference's export (`generate_train_tuples.py:366-374`,
    docstring `:1-8`).

    A 2-frame request routes to the `gather_pairs_train` crawl, like the
    reference's `crawl_subprocess_short` (`:140-219`; its export used a
    nonexistent dataset method — a latent dead-path bug — which we fix
    by mapping through valid-frame ids)."""
    valid_frames = dataset.get_valid_frame_ids(dataset.split, scan)
    frame_ids = [line.strip().split(" ")[1] for line in valid_frames]
    poses = [dataset.load_pose(scan.rstrip("\n"), fid)[0]
             for fid in frame_ids]

    if num_images_in_tuple == 2:
        used_pairs: set = set()
        chains = []
        for multiplier, backward in [(1.0, False), (0.666, True),
                                     (1.5, False)]:
            pairs = gather_pairs_train(
                poses, used_pairs, is_backward=backward,
                initial_pose_dist_min=(
                    multiplier * DVMVS_Config.train_minimum_pose_distance),
                initial_pose_dist_max=(
                    multiplier * DVMVS_Config.train_maximum_pose_distance))
            chains.extend([i, j] for i, j in pairs)
    else:
        chains = crawl_subsequences_train(poses, num_images_in_tuple)

    lines = []
    for chain in chains:
        ids = " ".join(str(frame_ids[i]) for i in chain)
        lines.append(f"{scan} {ids}")
    return lines


# ------------------------------------------------------------------
# the crawl over scans, in worker processes
# ------------------------------------------------------------------

def _scan_worker(args, dataset_factory, frame_tuple_type,
                 num_images_in_tuple, split):
    scan, progress, total = args
    np.random.seed(42)
    random.seed(42)
    dataset = dataset_factory()
    if split == "train" or frame_tuple_type is None:
        lines = generate_train_tuples_for_scan(dataset, scan,
                                               num_images_in_tuple)
    else:
        lines = generate_test_tuples_for_scan(dataset, scan,
                                              frame_tuple_type,
                                              num_images_in_tuple)
    progress.value += 1
    print(f"done {scan} ({progress.value}/{total}): {len(lines)} tuples")
    return lines


def crawl(scans: List[str], dataset_factory, frame_tuple_type: str,
          num_images_in_tuple: int, split: str,
          num_workers: int = 8) -> List[str]:
    """Fans scans out over a Pool (`generate_test_tuples.py:530-567`)."""
    np.random.seed(42)
    random.seed(42)
    manager = Manager()
    progress = manager.Value("i", 0)
    worker = partial(_scan_worker, dataset_factory=dataset_factory,
                     frame_tuple_type=frame_tuple_type,
                     num_images_in_tuple=num_images_in_tuple, split=split)
    args = [(scan, progress, len(scans)) for scan in scans]
    if num_workers <= 1:
        results = [worker(a) for a in args]
    else:
        with Pool(num_workers) as pool:
            results = pool.map(worker, args)
    lines: List[str] = []
    for r in results:
        lines.extend(r)
    if split == "train":
        random.shuffle(lines)  # (`generate_train_tuples.py:468`)
    return lines
