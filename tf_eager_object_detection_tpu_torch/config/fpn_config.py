"""FPN config preset (port of `tf_eager_object_detection_tpu/config/fpn_config.py`).

Same keys and values as the JAX preset, without the keys that only select or
tune TPU code paths: the Pallas RoIAlign's window, window dtype and einsum
contraction order (`tpu_roi_align_window`, `tpu_roi_align_window_dtype`,
`tpu_roi_align_contract`), the per-level pre-NMS prefilter
(`tpu_fpn_per_level_prenms`), `tpu_fused_optimizer` and `tpu_native_decode`.
The port's RoIAlign samples exactly, with no window. It keeps
`tpu_roi_align_fused_levels`: True (the default) samples every roi from its
level in one fused-pyramid kernel (K4, backward K5), False runs the
single-level kernel once per level and sums (K2, backward K3).
"""


def get_default_pascal_fpn_config():
    return {
        # backbone
        "resnet_roi_feature_size": (7, 7, 256),
        "roi_head_keep_dropout_rate": 0.5,
        # base configs
        "num_classes": 21,
        # fpn-specific
        "level_name_list": ["p2", "p3", "p4", "p5", "p6"],
        "min_level": 2,
        "max_level": 5,
        "top_down_dims": 256,
        # preprocessing configs
        "image_max_size": 1000,
        "image_min_size": 600,
        "bgr_pixel_means": [103.939, 116.779, 123.68],
        # predict & evaluate configs
        "evaluate_iou_threshold": 0.5,
        "max_objects_per_class_per_image": 50,
        "max_objects_per_image": 50,
        "prediction_nms_iou_threshold": 0.3,
        "prediction_score_threshold": 0.0,
        "show_image_score_threshold": 0.3,
        # anchors configs
        "ratios": [0.5, 1.0, 2.0],
        "scales": [1.0],
        "anchor_stride_list": [4, 8, 16, 32, 64],
        "base_anchor_size_list": [32, 64, 128, 256, 512],
        # training configs
        "learning_rate_multi_decay_steps": [60000, 80000],
        "learning_rate_multi_lrs": [1e-3, 1e-4, 1e-5],
        "optimizer_momentum": 0.9,
        "learning_rate_bias_double": False,
        "weight_decay": 0.0001,
        "epochs": 30,
        # rpn net configs
        "rpn_proposal_means": [0, 0, 0, 0],
        "rpn_proposal_stds": [1.0, 1.0, 1.0, 1.0],
        "rpn_sigma": 3.0,
        "rpn_pos_iou_threshold": 0.7,
        "rpn_neg_iou_threshold": 0.3,
        "rpn_total_sample_number": 256,
        "rpn_pos_sample_max_number": 128,
        "rpn_proposal_train_pre_nms_sample_number": 12000,
        "rpn_proposal_train_after_nms_sample_number": 2000,
        "rpn_proposal_test_pre_nms_sample_number": 6000,
        "rpn_proposal_test_after_nms_sample_number": 1000,
        "rpn_proposal_nms_iou_threshold": 0.7,
        "roi_pooling_size": 7,
        "roi_pooling_max_pooling_flag": True,
        # roi net configs
        "roi_proposal_means": [0, 0, 0, 0],
        "roi_proposal_stds": [0.1, 0.1, 0.2, 0.2],
        "roi_sigma": 1.0,
        "roi_pos_iou_threshold": 0.5,
        "roi_neg_iou_threshold": 0.0,
        "roi_total_sample_number": 256,
        "roi_pos_sample_max_number": 64,
        # see faster_rcnn_config.py
        "strict_reference_parity": False,
        # static padding buckets (multiples of 64, so every pyramid level
        # from stride 4 to 64 tiles evenly), padded gt capacity, images per
        # training step, compute dtype (the port serves float32)
        "tpu_image_buckets": [[640, 1024], [1024, 640]],
        "tpu_max_gt_boxes": 100,
        "tpu_train_batch_size_per_device": 1,
        "tpu_compute_dtype": "float32",
        # one fused-pyramid RoIAlign launch (True) or one per level (False)
        "tpu_roi_align_fused_levels": True,
    }


PASCAL_CONFIG = get_default_pascal_fpn_config()
