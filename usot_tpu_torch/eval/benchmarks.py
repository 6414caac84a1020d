"""OPE / Accuracy-Robustness / EAO / F1 benchmarks
(ref: lib/eval_toolkit/pysot/evaluation/). Same numerics, plain printing.

The port's own copy of `usot_tpu/eval/benchmarks.py` (host code, numpy
only)."""
from __future__ import annotations

import itertools
import warnings

import numpy as np

from usot_tpu_torch.eval.statistics import (calculate_accuracy,
                                            calculate_expected_overlap,
                                            calculate_f1, calculate_failures,
                                            determine_thresholds,
                                            success_error, success_overlap)


class OPEBenchmark:
    def __init__(self, dataset):
        self.dataset = dataset

    @staticmethod
    def convert_bb_to_center(bboxes):
        return np.array([(bboxes[:, 0] + (bboxes[:, 2] - 1) / 2),
                         (bboxes[:, 1] + (bboxes[:, 3] - 1) / 2)]).T

    def convert_bb_to_norm_center(self, bboxes, gt_wh):
        return self.convert_bb_to_center(bboxes) / (gt_wh + 1e-16)

    def _trajs(self, video, tracker_name):
        gt_traj = np.array(video.gt_traj)
        if tracker_name not in video.pred_trajs:
            traj = np.array(video.load_tracker(self.dataset.tracker_path,
                                               tracker_name, False))
        else:
            traj = np.array(video.pred_trajs[tracker_name])
        n_frame = len(gt_traj)
        if hasattr(video, "absent"):
            gt_traj = gt_traj[video.absent == 1]
            traj = traj[video.absent == 1]
        return gt_traj, traj, n_frame

    def eval_success(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        out = {}
        for tracker_name in eval_trackers:
            per_video = {}
            for video in self.dataset:
                gt, traj, n = self._trajs(video, tracker_name)
                per_video[video.name] = success_overlap(gt, traj, n)
            out[tracker_name] = per_video
        return out

    def eval_precision(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        out = {}
        for tracker_name in eval_trackers:
            per_video = {}
            for video in self.dataset:
                gt, traj, n = self._trajs(video, tracker_name)
                thresholds = np.arange(0, 51, 1)
                per_video[video.name] = success_error(
                    self.convert_bb_to_center(gt),
                    self.convert_bb_to_center(traj), thresholds, n)
            out[tracker_name] = per_video
        return out

    def eval_norm_precision(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        out = {}
        for tracker_name in eval_trackers:
            per_video = {}
            for video in self.dataset:
                gt, traj, n = self._trajs(video, tracker_name)
                thresholds = np.arange(0, 51, 1) / 100
                per_video[video.name] = success_error(
                    self.convert_bb_to_norm_center(gt, gt[:, 2:4]),
                    self.convert_bb_to_norm_center(traj, gt[:, 2:4]),
                    thresholds, n)
            out[tracker_name] = per_video
        return out

    def show_result(self, success_ret, precision_ret=None,
                    norm_precision_ret=None, show_video_level=False,
                    helight_threshold=0.6):
        """Pretty-print: trackers sorted by AUC (top 20); optional
        per-video table with sub-threshold cells in red
        (ref: ope_benchmark.py:124-195, incl. its 'helight' spelling)."""
        tracker_auc = {t: np.mean(list(success_ret[t].values()))
                       for t in success_ret}
        tracker_names = [t for t, _ in sorted(
            tracker_auc.items(), key=lambda x: x[1], reverse=True)[:20]]

        name_len = max(max(len(x) for x in success_ret) + 2, 12)
        header = (f"|{{:^{name_len}}}|{{:^9}}|{{:^16}}|{{:^11}}|").format(
            "Tracker name", "Success", "Norm Precision", "Precision")
        print("-" * len(header))
        print(header)
        print("-" * len(header))
        for t in tracker_names:
            precision = np.mean(list(precision_ret[t].values()),
                                axis=0)[20] if precision_ret else 0
            norm_p = np.mean(list(norm_precision_ret[t].values()),
                             axis=0)[20] if norm_precision_ret else 0
            print((f"|{{:^{name_len}}}|{{:^9.3f}}|{{:^16.3f}}|"
                   f"{{:^11.3f}}|").format(t, tracker_auc[t], norm_p,
                                           precision))
        print("-" * len(header))

        if show_video_level and len(success_ret) < 10 \
                and precision_ret is not None and len(precision_ret) < 10:
            print("\n\n")
            header1 = f"|{'Tracker name':^21}|"
            header2 = f"|{'Video name':^21}|"
            for t in success_ret:
                header1 += f"{t:^21}|"
                header2 += f"{'success':^9}|{'precision':^11}|"
            print("-" * len(header1))
            print(header1)
            print("-" * len(header1))
            print(header2)
            print("-" * len(header1))
            red = "\033[31m{}\033[0m"
            for video in list(success_ret[next(iter(success_ret))].keys()):
                row = f"|{video:^21}|"
                for t in success_ret:
                    success = np.mean(success_ret[t][video])
                    precision = np.mean(precision_ret[t][video])
                    s_str = f"{success:^9.3f}"
                    row += (red.format(s_str)
                            if success < helight_threshold else s_str) + "|"
                    p_str = f"{precision:^11.3f}"
                    row += (red.format(p_str)
                            if precision < helight_threshold else p_str) + "|"
                print(row)
            print("-" * len(header1))


class AccuracyRobustnessBenchmark:
    def __init__(self, dataset, burnin=10):
        self.dataset = dataset
        self.burnin = burnin

    def eval(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        result = {}
        for tracker_name in eval_trackers:
            overlaps, failures = self._calculate(tracker_name)
            result[tracker_name] = {"overlaps": overlaps, "failures": failures}
        return result

    def _calculate(self, tracker_name):
        overlaps, failures = {}, {}
        for video in self.dataset:
            gt_traj = video.gt_traj
            if tracker_name not in video.pred_trajs:
                trajs = video.load_tracker(self.dataset.tracker_path,
                                           tracker_name, False)
            else:
                trajs = video.pred_trajs[tracker_name]
            overlaps_group, fail_group = [], []
            for traj in trajs:
                fail_group.append(calculate_failures(traj)[0])
                overlaps_group.append(calculate_accuracy(
                    traj, gt_traj, burnin=self.burnin,
                    bound=(video.width, video.height))[1])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", category=RuntimeWarning)
                overlaps[video.name] = np.nanmean(overlaps_group,
                                                  axis=0).tolist()
                failures[video.name] = fail_group
        return overlaps, failures

    def show_result(self, result, eao_result=None, show_video_level=False,
                    helight_threshold=0.5):
        """Pretty-print: trackers ranked by EAO (top 20) when available;
        optional per-video Acc/LN table, red below threshold / any loss
        (ref: ar_benchmark.py show_result)."""
        name_len = max(max(len(x) for x in result) + 2, 12)
        header = f"|{{:^{name_len}}}|{'Accuracy':^10}|{'Robustness':^12}|" \
                 f"{'Lost':^8}|{'EAO':^7}|"
        header = header.format("Tracker name")
        print("-" * len(header))
        print(header)
        print("-" * len(header))
        if eao_result is not None:
            tracker_names = [x[0] for x in sorted(
                eao_result.items(), key=lambda x: x[1]["all"],
                reverse=True)[:20]]
        else:
            tracker_names = list(result.keys())
        for tracker_name in tracker_names:
            ret = result[tracker_name]
            overlaps = list(itertools.chain(*ret["overlaps"].values()))
            accuracy = np.nanmean(overlaps)
            length = sum(len(x) for x in ret["overlaps"].values())
            failures = list(ret["failures"].values())
            lost = np.mean(np.sum(failures, axis=0))
            robustness = np.mean(np.sum(np.array(failures), axis=0)
                                 / length) * 100
            eao = (eao_result or {}).get(tracker_name, {}).get("all", 0.0)
            print(f"|{tracker_name:^{name_len}}|{accuracy:^10.3f}|"
                  f"{robustness:^12.3f}|{lost:^8.1f}|{eao:^7.3f}|")
        print("-" * len(header))

        if show_video_level and len(result) < 10:
            print("\n\n")
            header1 = f"|{'Tracker name':^14}|"
            header2 = f"|{'Video name':^14}|"
            for tracker_name in result:
                header1 += f"{tracker_name:^17}|"
                header2 += f"{'Acc':^8}|{'LN':^8}|"
            print("-" * len(header1))
            print(header1)
            print("-" * len(header1))
            print(header2)
            print("-" * len(header1))
            red = "\033[31m{}\033[0m"
            videos = list(result[next(iter(result))]["overlaps"].keys())
            for video in videos:
                row = f"|{video:^14}|"
                for tracker_name in result:
                    acc = np.nanmean(result[tracker_name]["overlaps"][video])
                    ln = np.mean(result[tracker_name]["failures"][video])
                    a_str = f"{acc:^8.3f}"
                    row += (red.format(a_str)
                            if acc < helight_threshold else a_str) + "|"
                    l_str = f"{ln:^8.3f}"
                    row += (red.format(l_str) if ln > 0 else l_str) + "|"
                print(row)
            print("-" * len(header1))


class EAOBenchmark:
    def __init__(self, dataset, skipping=5, tags=("all",)):
        self.dataset = dataset
        self.skipping = skipping
        self.tags = list(tags)
        if dataset.name in ("VOT2018", "VOT2017"):
            self.low, self.high, self.peak = 100, 356, 160
        elif dataset.name == "VOT2016":
            self.low, self.high, self.peak = 108, 371, 168
        elif dataset.name == "VOT2019":
            self.low, self.high, self.peak = 46, 291, 128
        else:
            self.low, self.high, self.peak = 100, 356, 160

    def eval(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        return {t: self._calculate_eao(t, self.tags) for t in eval_trackers}

    def show_result(self, result):
        header = f"|{'Tracker name':^20}|{'EAO':^10}|"
        print("-" * len(header))
        print(header)
        print("-" * len(header))
        for name, eao in sorted(result.items(), key=lambda x: x[1]["all"],
                                reverse=True):
            print(f"|{name:^20}|{eao['all']:^10.3f}|")
        print("-" * len(header))

    def _calculate_eao(self, tracker_name, tags):
        all_overlaps, all_failures = [], []
        video_names, gt_traj_length = [], []
        for video in self.dataset:
            gt_traj = video.gt_traj
            if tracker_name not in video.pred_trajs:
                trajs = video.load_tracker(self.dataset.tracker_path,
                                           tracker_name, False)
            else:
                trajs = video.pred_trajs[tracker_name]
            for traj in trajs:
                gt_traj_length.append(len(gt_traj))
                video_names.append(video.name)
                overlaps = calculate_accuracy(
                    traj, gt_traj,
                    bound=(video.width - 1, video.height - 1))[1]
                failures = calculate_failures(traj)[1]
                all_overlaps.append(overlaps)
                all_failures.append(failures)
        return self._eao_from_parts(video_names, gt_traj_length,
                                    all_failures, all_overlaps,
                                    len(trajs), tags)

    def _eao_from_parts(self, video_names, gt_traj_length, all_failures,
                        all_overlaps, last_traj_count, tags):
        """EAO from gathered per-trajectory overlaps/failures (split out
        so the fragment math is testable without disk results)."""
        fragment_num = sum(len(x) + 1 for x in all_failures)
        max_len = max(len(x) for x in all_overlaps)
        # Upstream pysot quirk, KEPT for numeric parity: the per-sequence
        # weight uses the repetition count of the LAST loaded video, not
        # a per-video count. Do not "fix" this without also changing the
        # reference A/B harness — EAO numbers must match the toolkit.
        seq_weight = 1 / last_traj_count

        # A trajectory splits into fragments at each failure: tracking
        # restarts `skipping` frames after a failure, and each non-final
        # fragment also includes the failure frame itself (+1). The
        # fragment VALUE matrix is tag-independent — build it once; only
        # the per-fragment tag weights vary across tags.
        #
        # Row fill rules (VOT toolkit semantics): non-final fragments are
        # zero-padded to max_len and NaN overlaps inside them become 0;
        # the final fragment of a failing trajectory keeps NaN padding
        # past its end (0 inside); an unbroken trajectory is copied
        # verbatim, NaNs and all.
        fragments = np.full((fragment_num, max_len), np.nan)
        spans = []  # one (kind, video, start, end, denom) per row
        row = 0
        for name, traj_len, failures, overlaps in zip(
                video_names, gt_traj_length, all_failures, all_overlaps):
            n_ov = len(overlaps)
            if not failures:
                max_idx = min(n_ov, max_len)
                fragments[row, :max_idx] = overlaps[:max_idx]
                spans.append(("unbroken", name, 0, max_idx, max_idx))
                row += 1
                continue
            restarts = [0] + [f + self.skipping for f in failures
                              if f + self.skipping <= n_ov]
            for i, start in enumerate(restarts):
                if i < len(restarts) - 1:
                    end = restarts[i + 1] + 1
                    frag = np.nan_to_num(
                        np.asarray(overlaps[start:end], float))
                    fragments[row, :] = 0.0
                    spans.append(("mid", name, start, end, end - start))
                else:
                    frag = np.nan_to_num(
                        np.asarray(overlaps[start:], float))
                    spans.append(("final", name, start, n_ov,
                                  traj_len - start + 1e-16))
                fragments[row, :len(frag)] = frag
                row += 1

        eao = {}
        for tag in tags:
            fweights = np.empty(fragment_num)
            for r, (kind, name, start, end, denom) in enumerate(spans):
                tag_frac = sum(self.dataset[name].select_tag(
                    tag, start, end)) / denom
                fweights[r] = seq_weight * tag_frac
            expected_overlaps = calculate_expected_overlap(fragments, fweights)
            weight = np.zeros(len(expected_overlaps))
            weight[self.low - 1:self.high] = 1
            is_valid = np.logical_not(np.isnan(expected_overlaps))
            eao[tag] = np.sum(expected_overlaps[is_valid]
                              * weight[is_valid]) / np.sum(weight[is_valid])
        return eao


class F1Benchmark:
    """Long-term tracking precision/recall/F1 over confidence thresholds
    (ref: pysot/evaluation/f1_benchmark.py)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def eval(self, eval_trackers):
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        ret = {}
        for tracker_name in eval_trackers:
            precision, recall, f1 = self._calculate(tracker_name)
            ret[tracker_name] = {"precision": precision, "recall": recall,
                                 "f1": f1}
        return ret

    def _calculate(self, tracker_name):
        """ref: pysot/evaluation/f1_benchmark.py:_cal_precision_reall —
        thresholds from ALL videos' full confidence lists (the leading NaN
        is dropped inside determine_thresholds)."""
        score = []
        for video in self.dataset:
            if tracker_name not in video.confidence:
                video.load_tracker(self.dataset.tracker_path, tracker_name)
            conf = video.confidence.get(tracker_name)
            if conf is None:
                continue
            score += conf
        score = np.array(score)
        thresholds = determine_thresholds(score)[::-1]

        precision = {}
        recall = {}
        f1 = {}
        for video in self.dataset:
            gt_traj = video.gt_traj
            N = sum(1 for x in gt_traj if len(x) > 1)
            traj = video.pred_trajs.get(tracker_name)
            conf = video.confidence.get(tracker_name)
            if traj is None:
                continue
            overlaps = calculate_accuracy(
                traj, gt_traj, bound=(video.width, video.height))[1]
            f1_, precision_, recall_ = calculate_f1(
                overlaps, conf, (video.width, video.height),
                thresholds, N)
            precision[video.name] = precision_
            recall[video.name] = recall_
            f1[video.name] = f1_
        return precision, recall, f1

    def show_result(self, result, show_video_level=False,
                    helight_threshold=0.5):
        """Pretty-print: trackers sorted by best-threshold F1 (top 20);
        optional per-video table (ref: f1_benchmark.py show_result)."""
        summary = {}
        for name, ret in result.items():
            precision = np.mean(list(ret["precision"].values()), axis=0)
            recall = np.mean(list(ret["recall"].values()), axis=0)
            f1 = 2 * precision * recall / (precision + recall + 1e-16)
            max_idx = np.argmax(f1)
            summary[name] = (precision[max_idx], recall[max_idx],
                             f1[max_idx])
        names = [x[0] for x in sorted(summary.items(),
                                      key=lambda x: x[1][2],
                                      reverse=True)[:20]]
        name_len = max(max(len(x) for x in result) + 2, 12)
        header = f"|{{:^{name_len}}}|{'Precision':^11}|{'Recall':^8}|" \
                 f"{'F1':^7}|"
        header = header.format("Tracker name")
        print("-" * len(header))
        print(header)
        print("-" * len(header))
        for name in names:
            pr, rc, f1v = summary[name]
            print(f"|{name:^{name_len}}|{pr:^11.3f}|{rc:^8.3f}|"
                  f"{f1v:^7.3f}|")
        print("-" * len(header))

        if show_video_level and len(result) < 10:
            print("\n\n")
            header1 = f"|{'Tracker name':^14}|"
            header2 = f"|{'Video name':^14}|"
            for name in result:
                header1 += f"{name:^28}|"
                header2 += f"{'Precision':^11}|{'Recall':^8}|{'F1':^7}|"
            print("-" * len(header1))
            print(header1)
            print("-" * len(header1))
            print(header2)
            print("-" * len(header1))
            red = "\033[31m{}\033[0m"
            videos = list(result[next(iter(result))]["precision"].keys())
            for video in videos:
                row = f"|{video:^14}|"
                for name in result:
                    f1 = np.asarray(result[name]["f1"][video])
                    max_idx = int(np.argmax(f1))
                    pr = result[name]["precision"][video][max_idx]
                    rc = result[name]["recall"][video][max_idx]
                    f1v = f1[max_idx]
                    for val, w in ((pr, 11), (rc, 8), (f1v, 7)):
                        s = f"{val:^{w}.3f}"
                        row += (red.format(s)
                                if val < helight_threshold else s) + "|"
                print(row)
            print("-" * len(header1))
