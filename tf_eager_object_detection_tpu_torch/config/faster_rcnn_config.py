"""Faster R-CNN config presets (port of `tf_eager_object_detection_tpu/config/faster_rcnn_config.py`).

Same keys and values as the JAX presets, so one config dict drives either
package. Keys that only select TPU code paths (`tpu_roi_align_contract`,
`tpu_fused_optimizer`, `tpu_native_decode`) are left out; the `tpu_` keys
kept here describe the data (static image buckets, padded gt capacity, batch)
and the compute dtype, which the port reads under the same names.
"""


def get_default_pascal_faster_rcnn_config():
    return {
        # vgg16
        "vgg16_roi_feature_size": (7, 7, 512),
        "roi_head_keep_dropout_rate": 0.5,
        "vgg16_roi_pooling_max_pooling_flag": True,
        # resnet
        "resnet_roi_feature_size": (7, 7, 1024),
        "resnet_roi_pooling_max_pooling_flag": False,
        # base configs
        "num_classes": 21,
        "weight_decay": 0.0001,
        # anchors configs
        "ratios": [0.5, 1.0, 2.0],
        "scales": [8, 16, 32],
        "extractor_stride": 16,
        # training configs
        "learning_rate_multi_decay_steps": [80000],
        "learning_rate_multi_lrs": [1e-3, 1e-4],
        "learning_rate_bias_double": True,
        "optimizer_momentum": 0.9,
        "epochs": 14,
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
        # anchor target & region proposal
        "rpn_proposal_means": [0, 0, 0, 0],
        "rpn_proposal_stds": [1.0, 1.0, 1.0, 1.0],
        # anchor target
        "rpn_sigma": 3.0,
        "rpn_pos_iou_threshold": 0.7,
        "rpn_neg_iou_threshold": 0.3,
        "rpn_total_sample_number": 256,
        "rpn_pos_sample_max_number": 128,
        # region proposal
        "rpn_proposal_train_pre_nms_sample_number": 12000,
        "rpn_proposal_train_after_nms_sample_number": 2000,
        "rpn_proposal_test_pre_nms_sample_number": 6000,
        "rpn_proposal_test_after_nms_sample_number": 300,
        "rpn_proposal_nms_iou_threshold": 0.7,
        # proposal target & prediction
        "roi_proposal_means": [0, 0, 0, 0],
        "roi_proposal_stds": [0.1, 0.1, 0.2, 0.2],
        # roi pooling
        "roi_pooling_size": 7,
        # proposal target
        "roi_sigma": 1.0,
        "roi_pos_iou_threshold": 0.5,
        "roi_neg_iou_threshold": 0.0,
        "roi_total_sample_number": 128,
        "roi_pos_sample_max_number": 32,
        # True: the reference's unclamped box decode (bbox_transform.py:32-55);
        # False: deltas clamped at log(1000/16), NaN-safe
        "strict_reference_parity": False,
        # static padding buckets (landscape, portrait), padded gt capacity,
        # images per training step, compute dtype (the port serves float32)
        "tpu_image_buckets": [[608, 1008], [1008, 608]],
        "tpu_max_gt_boxes": 100,
        "tpu_train_batch_size_per_device": 1,
        "tpu_compute_dtype": "float32",
    }


def get_default_coco_faster_rcnn_config():
    cfg = get_default_pascal_faster_rcnn_config()
    cfg.update(
        {
            "num_classes": 81,
            "scales": [4, 8, 16, 32],
            "learning_rate_multi_decay_steps": [350000],
            "epochs": 6,
            "bgr_pixel_means": [102.9801, 115.9465, 122.7717],
            "max_objects_per_class_per_image": 100,
            "max_objects_per_image": 100,
        }
    )
    return cfg


PASCAL_CONFIG = get_default_pascal_faster_rcnn_config()
COCO_CONFIG = get_default_coco_faster_rcnn_config()
