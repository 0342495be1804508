"""The port's own copy of the config cascade under `local_configs/`.

`load_config("local_configs.NYUDepthv2.DFormer_Large")` returns the same
`AttrDict` as the JAX package's loader: the root base (seed, data root from
`DFORMER_DATA_ROOT`), a dataset base (NYUDepthv2, SUNRGBD, Trav or the
template's), then the model/train/eval section every leaf applies. Nothing
under `local_configs/` is imported or executed: its base module imports the
JAX package. A test holds every key of every leaf to the JAX loader's.
"""

import os
import os.path as osp
import time

import numpy as np

from dformer_torch.config import AttrDict

NYU_CLASS_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "night stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
]

SUNRGBD_CLASS_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor_mat", "clothes",
    "ceiling", "books", "fridge", "tv", "paper", "towel", "shower_curtain",
    "box", "whiteboard", "person", "night_stand", "toilet", "sink", "lamp",
    "bathtub", "bag",
]

# the Trav lidar scan's z-score statistics
TRAV_LIDAR_MEAN = 3.712411900604355
TRAV_LIDAR_STD = 1.4213359933145486

_RGB_MEAN = (0.485, 0.456, 0.406)
_RGB_STD = (0.229, 0.224, 0.225)


def base_config() -> AttrDict:
    C = AttrDict()
    C.seed = 8964
    C.root_dir = os.environ.get("DFORMER_DATA_ROOT", "datasets")
    C.abs_dir = osp.realpath(".")
    return C


def _dataset(name, folder, label_folder, gt_transform, train_source,
             eval_source, num_train, num_eval, class_names, hw,
             mean=_RGB_MEAN, std=_RGB_STD) -> AttrDict:
    C = base_config()
    C.dataset_name = name
    C.dataset_path = osp.join(C.root_dir, folder)
    C.rgb_root_folder = osp.join(C.dataset_path, "RGB")
    C.rgb_format = ".jpg"
    C.gt_root_folder = osp.join(C.dataset_path, label_folder)
    C.gt_format = ".png"
    C.gt_transform = gt_transform
    C.x_root_folder = osp.join(C.dataset_path, "Depth")
    C.x_format = ".png"
    C.x_is_single_channel = True
    C.train_source = osp.join(C.dataset_path, train_source)
    C.eval_source = osp.join(C.dataset_path, eval_source)
    C.is_test = True
    C.num_train_imgs = num_train
    C.num_eval_imgs = num_eval
    C.num_classes = len(class_names)
    C.class_names = list(class_names)
    C.background = 255
    C.image_height, C.image_width = hw
    C.norm_mean = np.array(mean)
    C.norm_std = np.array(std)
    return C


def nyudepthv2_dataset() -> AttrDict:
    """label 0 is invalid: classes shift down by one (gt_transform)."""
    return _dataset("NYUDepthv2", "NYUDepthv2", "Label", True, "train.txt",
                    "test.txt", 795, 654, NYU_CLASS_NAMES, (480, 640))


def sunrgbd_dataset() -> AttrDict:
    return _dataset("SUNRGBD", "SUNRGBD", "labels", True, "train.txt",
                    "test.txt", 5285, 5050, SUNRGBD_CLASS_NAMES, (480, 480))


def trav_dataset() -> AttrDict:
    """Robot traversability: RGB + a 360-beam lidar scan, binary labels."""
    C = base_config()
    C.dataset = "Trav"
    C.dataset_name = "Trav"
    C.scenes = ["erb", "uc", "wh"]
    C.update(_dataset("Trav", "trav", "labels", False, "df1.csv", "df2.csv",
                      421, 423, [0, 1], (480, 640),
                      (0.5174, 0.4857, 0.5054), (0.2726, 0.2778, 0.2861)))
    C.x_mean = TRAV_LIDAR_MEAN
    C.x_std = TRAV_LIDAR_STD
    return C


def template_dataset() -> AttrDict:
    """The template for a new dataset: NYUDepthv2's layout and sizes under
    another name, with placeholder class names."""
    return _dataset("MyDataset", "MyDataset", "Label", True, "train.txt",
                    "test.txt", 795, 654,
                    [f"class_{i}" for i in range(40)], (480, 640))


def apply_model_section(
    C,
    backbone: str,
    pretrained_name: str,
    lr: float,
    batch_size: int,
    nepochs: int,
    drop_path_rate: float,
    checkpoint_start_epoch: int,
    eval_scale_array=(1,),
    decoder: str = "ham",
    decoder_embed_dim: int = 512,
):
    """The model, train and eval fields every leaf config sets."""
    C.backbone = backbone
    C.pretrained_model = osp.join("checkpoints", "pretrained", pretrained_name)
    C.decoder = decoder
    C.decoder_embed_dim = decoder_embed_dim
    C.optimizer = "AdamW"

    C.lr = lr
    C.lr_power = 0.9
    C.momentum = 0.9
    C.weight_decay = 0.01
    C.batch_size = batch_size
    C.nepochs = nepochs
    C.niters_per_epoch = C.num_train_imgs // C.batch_size + 1
    C.num_workers = 16
    C.train_scale_array = [0.5, 0.75, 1, 1.25, 1.5, 1.75]
    C.warm_up_epoch = 10

    C.fix_bias = True
    C.bn_eps = 1e-3
    C.bn_momentum = 0.1
    C.drop_path_rate = drop_path_rate
    C.aux_rate = 0.0

    C.eval_iter = 25
    C.eval_stride_rate = 2 / 3
    C.eval_scale_array = list(eval_scale_array)
    C.eval_flip = True
    C.eval_crop_size = [C.image_height, C.image_width]

    C.checkpoint_start_epoch = checkpoint_start_epoch
    C.checkpoint_step = 25

    # paths only: no directory is created here
    C.log_dir_base = osp.abspath(
        osp.join("checkpoints", f"{C.dataset_name}_{C.backbone}"))
    C.log_dir = C.log_dir_base
    C.tb_dir = osp.join(C.log_dir, "tb")
    C.checkpoint_dir = osp.join(C.log_dir, "checkpoint")
    C.log_dir_link = C.log_dir
    return C


def _trav_base() -> AttrDict:
    """DFormerTrav-Base fine-tuning on Trav, with the few-shot fields."""
    C = apply_model_section(
        trav_dataset(), backbone="DFormerTrav-Base",
        pretrained_name="DFormerTrav_Base_epoch-1_miou_61.19.pt", lr=6e-5,
        batch_size=2, nepochs=100, drop_path_rate=0.1,
        checkpoint_start_epoch=250)
    C.use_wandb = False
    C.num_classes = 2
    C.shots = 5
    C.epochs = 100
    C.episodes_per_epoch = 100
    C.num_workers = 8
    C.warm_up_epoch = 5
    C.temperature = 1
    C.alpha = 0.5
    C.eval_iterations = 1000
    C.checkpoint_step = 10
    C.save_dir = "output/unlabeled_masks"
    C.log_dir_base = osp.abspath(osp.join("checkpoints", "trained", "trav",
                                          C.backbone))
    return C


def _leaf(dataset, variant, lr, batch_size, nepochs, drop_path_rate,
          checkpoint_start_epoch, **extra):
    return lambda: apply_model_section(
        dataset(), backbone=f"DFormer-{variant}",
        pretrained_name=f"DFormer_{variant}.pth.tar", lr=lr,
        batch_size=batch_size, nepochs=nepochs,
        drop_path_rate=drop_path_rate,
        checkpoint_start_epoch=checkpoint_start_epoch, **extra)


# dotted path of the leaf module under local_configs -> its construction
LEAVES = {
    "local_configs.NYUDepthv2.DFormer_Tiny":
        _leaf(nyudepthv2_dataset, "Tiny", 6e-5, 8, 500, 0.1, 250),
    "local_configs.NYUDepthv2.DFormer_Small":
        _leaf(nyudepthv2_dataset, "Small", 6e-5, 8, 500, 0.1, 250),
    "local_configs.NYUDepthv2.DFormer_Base":
        _leaf(nyudepthv2_dataset, "Base", 6e-5, 4, 50, 0.1, 250),
    "local_configs.NYUDepthv2.DFormer_Large":
        _leaf(nyudepthv2_dataset, "Large", 6e-5, 8, 500, 0.15, 250),
    "local_configs.SUNRGBD.DFormer_Tiny":
        _leaf(sunrgbd_dataset, "Tiny", 8e-5, 16, 300, 0.1, 200),
    "local_configs.SUNRGBD.DFormer_Small":
        _leaf(sunrgbd_dataset, "Small", 8e-5, 16, 300, 0.1, 200),
    "local_configs.SUNRGBD.DFormer_Base":
        _leaf(sunrgbd_dataset, "Base", 8e-5, 16, 300, 0.1, 200),
    "local_configs.SUNRGBD.DFormer_Large":
        _leaf(sunrgbd_dataset, "Large", 8e-5, 16, 300, 0.2, 200,
              eval_scale_array=(0.5, 0.75, 1, 1.25, 1.5)),
    "local_configs.Trav.DFormer_Base": _trav_base,
    "local_configs.template.DFormer_Large":
        _leaf(template_dataset, "Large", 6e-5, 8, 500, 0.15, 250),
}


def load_config(path: str) -> AttrDict:
    """A fresh config for the dotted leaf path, e.g.
    "local_configs.NYUDepthv2.DFormer_Large"."""
    try:
        make = LEAVES[path]
    except KeyError:
        raise KeyError(f"unknown config {path!r}; known: "
                       f"{', '.join(sorted(LEAVES))}") from None
    return make()


def finalize_run_dirs(cfg: AttrDict) -> AttrDict:
    """Timestamped run directories, made: log_dir (`log_dir_base` + a
    stamp), tb_dir and checkpoint_dir in it; log_file and val_log_file
    named there."""
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime())
    base = cfg.get("log_dir_base",
                   osp.abspath(f"checkpoints/{cfg.dataset_name}_{cfg.backbone}"))
    cfg.log_dir = f"{base}_{stamp}"
    cfg.tb_dir = osp.join(cfg.log_dir, "tb")
    cfg.checkpoint_dir = osp.join(cfg.log_dir, "checkpoint")
    exp_time = time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime())
    cfg.log_file = osp.join(cfg.log_dir, f"log_{exp_time}.log")
    cfg.val_log_file = osp.join(cfg.log_dir, f"val_{exp_time}.log")
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    os.makedirs(cfg.tb_dir, exist_ok=True)
    return cfg
