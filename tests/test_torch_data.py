"""The port's data layer against the JAX package's, on the same inputs.

Every transform of data/seg_transforms.py at tolerance 0 after the JAX
package's HWC -> CHW (the random ones with random.Random(s) in the port and
random.seed(s) on the JAX side); the three datasets on synthetic trees like
tests/test_data.py's (samples, classes, weights and the class-presence
cache, each package on its own copy of the tree); the samplers' index
sequences; the loader's batches, drop_last and pad_last, in this process and
in worker processes; the native host ops against their plain twins; the
archive extraction, the display helpers, the metric classes, the meters and
the registry's data aliases.
"""

import os
import random
import shutil
import tarfile
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from hyperseg_tpu.data import seg_transforms as JT
from hyperseg_torch import native
from hyperseg_torch.data import seg_transforms as T

MEAN, STD = (0.41, 0.43, 0.44), (0.27, 0.29, 0.28)


def make_pair(w=64, h=48, seed=0):
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
    lab = rng.randint(0, 19, (h, w)).astype(np.uint8)
    lab[:, :3] = 255
    return img, Image.fromarray(lab, mode="P")


def assert_same_sample(got, want):
    """A port sample (CHW tensor or list of them, uint8 label tensor)
    equals a JAX one (HWC array or list, int32 label) exactly."""
    gimg, glbl = got
    wimg, wlbl = want
    if isinstance(wimg, (list, tuple)):
        assert isinstance(gimg, list) and len(gimg) == len(wimg)
        for g, w in zip(gimg, wimg):
            assert_same_sample((g, glbl), (w, wlbl))
        return
    assert gimg.dtype == torch.float32 and gimg.shape == (wimg.shape[2],) + wimg.shape[:2]
    np.testing.assert_array_equal(gimg.numpy().transpose(1, 2, 0), wimg)
    assert glbl.dtype == torch.uint8
    np.testing.assert_array_equal(glbl.numpy().astype(np.int32), wlbl)


# name -> (transforms of either module, seeded); a factory so each side
# builds its own objects from its module
PIPELINES = {
    "resize": (lambda m: [m.Resize((24, 32)), m.ToArray(), m.Normalize()], False),
    "larger_edge_resize": (lambda m: [m.LargerEdgeResize(40), m.ToArray()], False),
    "image_resize": (lambda m: [m.ImageResize([24, 32]), m.ToArray(), m.Normalize(MEAN, STD)],
                     False),
    "constant_pad": (lambda m: [m.ConstantPad((80, 56), fill=3, lbl_fill=255), m.ToArray()],
                     False),
    "constant_pad_square": (lambda m: [m.ConstantPad(72, lbl_fill=255), m.ToTensor()], False),
    "random_resize_range": (lambda m: [m.RandomResize(p=0.7, scale_range=(0.5, 1.5)),
                                       m.ToArray()], True),
    "random_resize_values": (lambda m: [m.RandomResize(p=0.9, scale_values=[0.5, 0.75, 1.25]),
                                        m.ToArray()], True),
    "random_crop_pad_if_needed": (lambda m: [m.RandomCrop([56, 80], pad_if_needed=True,
                                                          lbl_fill=255), m.ToArray()], True),
    "random_crop_padding": (lambda m: [m.RandomCrop(32, padding=4, fill=1, lbl_fill=255),
                                       m.ToArray()], True),
    "random_crop_reflect": (lambda m: [m.RandomCrop(40, padding=(3, 5), padding_mode="reflect"),
                                       m.ToArray()], True),
    "random_hflip": (lambda m: [m.RandomHorizontalFlip(), m.ToArray()], True),
    "random_vflip": (lambda m: [m.RandomVerticalFlip(), m.ToArray()], True),
    "random_gaussian_blur": (lambda m: [m.RandomGaussianBlur(p=0.5, r=2), m.ToArray()], True),
    "random_rotation": (lambda m: [m.RandomRotation(15, fill=0, lbl_fill=255), m.ToArray()],
                        True),
    "color_jitter": (lambda m: [m.ColorJitter(0.4, 0.4, 0.4, 0.1), m.ToArray()], True),
    "pyramids": (lambda m: [m.Pyramids(3), m.ToArray()], False),
    "up_down_pyramids": (lambda m: [m.UpDownPyramids(2, 1), m.ToArray(), m.Normalize()], False),
    "to_normalized_array": (lambda m: [m.ToNormalizedArray(MEAN, STD)], False),
    "train_chain": (lambda m: [m.RandomResize(scale_range=(0.5, 1.5)),
                               m.RandomCrop((40, 56), pad_if_needed=True, lbl_fill=255),
                               m.RandomHorizontalFlip(), m.ColorJitter(0.3, 0.3, 0.3),
                               m.ToArray(), m.Normalize(MEAN, STD)], True),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_transforms_match_jax(name):
    """Each pipeline on the same PIL pair: the port's output equals the JAX
    one's transposed, exactly; random pipelines under three seeds, the
    port's drawing from Compose.seed(s), the JAX one's after random.seed(s)."""
    factory, seeded = PIPELINES[name]
    img, lbl = make_pair()
    for s in (0, 1, 2) if seeded else (None,):
        tf = T.Compose(factory(T))
        if seeded:
            tf.seed(s)
        got = tf(img, lbl)
        if seeded:
            random.seed(s)
        want = JT.Compose(factory(JT))(img, lbl)
        assert_same_sample(got, want)


@pytest.mark.parametrize("cls", ["RandomResize", "RandomCrop", "RandomHorizontalFlip",
                                 "RandomVerticalFlip", "RandomGaussianBlur", "RandomRotation",
                                 "ColorJitter"])
def test_random_transform_takes_its_rng(cls):
    """A random transform given random.Random(s) draws what the JAX one draws
    after random.seed(s), on repeated calls, and no longer touches the
    module-global generator."""
    kw = {"RandomResize": dict(p=0.8, scale_range=(0.5, 2.0)), "RandomCrop": dict(size=24),
          "RandomGaussianBlur": dict(r=2), "RandomRotation": dict(degrees=30),
          "ColorJitter": dict(brightness=0.5, contrast=0.5, saturation=0.5, hue=0.2)}.get(cls, {})
    img, lbl = make_pair(seed=3)
    port = getattr(T, cls)(**kw, rng=random.Random(7))
    ref = getattr(JT, cls)(**kw)
    random.seed(7)
    want = [ref(img, lbl) if isinstance(ref, JT.SegTransform) else (ref(img), lbl)
            for _ in range(4)]
    state = random.getstate()
    got = [port(img, lbl) if isinstance(port, T.SegTransform) else (port(img), lbl)
           for _ in range(4)]
    assert random.getstate() == state
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))


def test_compose_routes_pair_vs_image_only():
    """SegTransforms see the pair, anything else the image alone; ToArray
    emits CHW float32 and a uint8 label (tests/test_data.py's check)."""
    img, lbl = make_pair()
    calls = []
    tf = T.Compose([T.Resize((24, 32)), lambda x: calls.append(x) or x, T.ToArray(),
                    T.Normalize()])
    out_img, out_lbl = tf(img, lbl)
    assert len(calls) == 1 and isinstance(calls[0], Image.Image)
    assert out_img.shape == (3, 24, 32) and out_img.dtype == torch.float32
    assert out_lbl.shape == (24, 32) and out_lbl.dtype == torch.uint8
    assert T.ToTensor is T.ToArray


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------


def make_camvid_tree(root, n=3, size=(32, 48)):
    from hyperseg_tpu.data.camvid import CLASS_COLOR
    rng = np.random.RandomState(1)
    colors = np.asarray(CLASS_COLOR, np.uint8)
    for split in ["train", "test"]:
        os.makedirs(root / split, exist_ok=True)
        os.makedirs(root / f"{split}_labels", exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (*size, 3), np.uint8)).save(
                root / split / f"f{i}.png")
            lab = colors[rng.randint(0, len(colors), (size[0] // 8, size[1] // 8))]
            lab = lab.repeat(8, 0).repeat(8, 1)
            lab[0, 0] = (7, 7, 7)  # unknown colour -> 255
            Image.fromarray(lab).save(root / f"{split}_labels" / f"f{i}_L.png")


def make_cityscapes_tree(root, split="val", cities=("cityA", "cityB"), n=2, size=(64, 128)):
    rng = np.random.RandomState(2)
    for city in cities:
        img_dir = root / "leftImg8bit" / split / city
        tgt_dir = root / "gtFine" / split / city
        os.makedirs(img_dir), os.makedirs(tgt_dir)
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (*size, 3), np.uint8)).save(
                img_dir / f"{city}_{i:06d}_leftImg8bit.png")
            lab = rng.randint(0, 34, (size[0] // 8, size[1] // 8)).astype(np.uint8)
            Image.fromarray(lab.repeat(8, 0).repeat(8, 1)).save(
                tgt_dir / f"{city}_{i:06d}_gtFine_labelIds.png")


def make_voc_tree(root, n=3):
    voc_root = root / "VOCdevkit" / "VOC2012"
    os.makedirs(voc_root / "JPEGImages"), os.makedirs(voc_root / "SegmentationClassAug")
    rng = np.random.RandomState(3)
    lines = []
    for i in range(n):
        h, w = (32, 48) if i % 2 else (48, 32)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            voc_root / "JPEGImages" / f"img{i}.jpg")
        lab = np.zeros((h, w), np.uint8)
        lab[:16] = 1 + i
        lab[-2:] = 255
        Image.fromarray(lab).save(voc_root / "SegmentationClassAug" / f"img{i}.png")
        lines.append(f"/JPEGImages/img{i}.jpg /SegmentationClassAug/img{i}.png")
    (voc_root / "val.txt").write_text("\n".join(lines) + "\n")


def both_datasets(tmp_path, make, build):
    """(port dataset, JAX dataset), each on its own copy of one tree, so
    that each writes its own class-presence cache."""
    make(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    from hyperseg_torch.data import camvid, cityscapes, voc_sbd
    from hyperseg_tpu.data import camvid as jcamvid, cityscapes as jcityscapes, voc_sbd as jvoc
    port = build(dict(camvid=camvid, cityscapes=cityscapes, voc_sbd=voc_sbd, T=T),
                 tmp_path / "port")
    ref = build(dict(camvid=jcamvid, cityscapes=jcityscapes, voc_sbd=jvoc, T=JT),
                tmp_path / "jax")
    return port, ref


DATASETS = {
    "camvid": (make_camvid_tree, lambda m, r: m["camvid"].CamVidDataset(
        str(r), "train", transforms=m["T"].Compose([m["T"].ToArray(), m["T"].Normalize()]))),
    "cityscapes": (make_cityscapes_tree, lambda m, r: m["cityscapes"].CityscapesDataset(
        str(r), "val", "fine", "semantic", transforms=m["T"].Compose(
            [m["T"].ImageResize([32, 64]), m["T"].ToArray(), m["T"].Normalize()]))),
    "voc_sbd": (make_voc_tree, lambda m, r: m["voc_sbd"].VOCSBDDataset(
        str(r), "val", transforms=m["T"].Compose(
            [m["T"].ConstantPad(64, lbl_fill=255), m["T"].ToArray(), m["T"].Normalize()]))),
}
CACHES = {"cityscapes": "val.npy", "voc_sbd": "VOCdevkit/VOC2012/val.npy"}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_matches_jax(tmp_path, name):
    """Every sample, the classes, the sampling weights, the colour map and
    the class-presence cache (same file name, same content) equal the JAX
    dataset's."""
    port, ref = both_datasets(tmp_path, *DATASETS[name])
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        assert_same_sample(port[i], ref[i])
    assert [getattr(c, "name", c) for c in port.classes] == \
        [getattr(c, "name", c) for c in ref.classes]
    np.testing.assert_array_equal(np.asarray(port.weights), np.asarray(ref.weights))
    np.testing.assert_array_equal(np.asarray(port.color_map), np.asarray(ref.color_map))
    if name in CACHES:
        np.testing.assert_array_equal(port.image_classes, ref.image_classes)
        np.testing.assert_array_equal(np.load(tmp_path / "port" / CACHES[name]),
                                      np.load(tmp_path / "jax" / CACHES[name]))


def test_cityscapes_from_local_zips_and_test_split(tmp_path):
    """The dataset extracts local zips where the trees are missing, maps ids
    to train ids (void and license plate -> 255) as JAX does, and the test
    split returns indices."""
    from hyperseg_torch.data.cityscapes import CityscapesDataset, ID_TO_TRAIN_ID
    from hyperseg_tpu.data.cityscapes import ID_TO_TRAIN_ID as J_ID_TO_TRAIN_ID
    np.testing.assert_array_equal(ID_TO_TRAIN_ID, J_ID_TO_TRAIN_ID)
    src = tmp_path / "src"
    make_cityscapes_tree(src, cities=("cityA",), n=1)
    make_cityscapes_tree(src, split="test", cities=("cityC",), n=1)
    root = tmp_path / "root"
    os.makedirs(root)
    for top, name in (("leftImg8bit", "leftImg8bit_trainvaltest.zip"),
                      ("gtFine", "gtFine_trainvaltest.zip")):
        with zipfile.ZipFile(root / name, "w") as z:
            for d, _, files in os.walk(src / top):
                for f in files:
                    p = os.path.join(d, f)
                    z.write(p, os.path.relpath(p, src))
    ds = CityscapesDataset(str(root), "val", transforms=T.Compose([T.ToArray()]))
    img, lbl = ds[0]
    raw = np.array(Image.open(root / "gtFine" / "val" / "cityA" /
                              "cityA_000000_gtFine_labelIds.png"))
    np.testing.assert_array_equal(lbl.numpy(), J_ID_TO_TRAIN_ID[raw])
    test = CityscapesDataset(str(root), "test", transforms=T.Compose([T.ToArray()]))
    assert test.return_indices and test[0][1] == 0 and test.image_classes is None


def test_voc_sbd_needs_its_pair_list_and_extracts_local_archives(tmp_path):
    """With nothing under the root the dataset raises the JAX package's
    message and downloads nothing; a staged VOC tar is extracted."""
    from hyperseg_torch.data import voc_sbd
    with pytest.raises(RuntimeError, match="pair list not found"):
        voc_sbd.VOCSBDDataset(str(tmp_path / "empty"), "val.txt")
    make_voc_tree(tmp_path / "staged")
    root = tmp_path / "root"
    os.makedirs(root)
    with tarfile.open(root / voc_sbd.VOC_TAR, "w") as tar:
        tar.add(tmp_path / "staged" / "VOCdevkit", arcname="VOCdevkit")
    ds = voc_sbd.VOCSBDDataset(str(root), "val", transforms=T.Compose([T.ToArray()]))
    img, lbl = ds[1]
    assert img.shape == (3, 32, 48) and lbl.dtype == torch.uint8
    assert lbl[0, 0] == 2 and lbl[31, 0] == 255 and len(ds.classes) == 21


def test_label_tensor_refuses_values_past_uint8():
    from hyperseg_torch.data.datasets import label_tensor
    assert label_tensor(np.array([[0, 255]], np.int32)).dtype == torch.uint8
    with pytest.raises(ValueError, match="uint8"):
        label_tensor(np.array([[0, 256]], np.int32))


# --------------------------------------------------------------------------
# samplers and the loader
# --------------------------------------------------------------------------


class Sized:
    def __len__(self):
        return 11


@pytest.mark.parametrize("kind", ["random", "random_weighted", "shuffle", "sequential"])
def test_samplers_match_jax(kind):
    from hyperseg_torch.data import loader as L
    from hyperseg_tpu.data import loader as JL
    w = np.arange(1, 12, dtype=np.float64)
    make = {"random": lambda m: m.RandomSampler(Sized(), 25, seed=4),
            "random_weighted": lambda m: m.RandomSampler(Sized(), 25, seed=4, weights=w),
            "shuffle": lambda m: m.ShuffleSampler(Sized(), seed=5),
            "sequential": lambda m: m.SequentialSampler(Sized())}[kind]
    got, want = make(L), make(JL)
    assert len(got) == len(want)
    for _ in range(2):    # a second pass continues each generator alike
        assert list(got) == [int(i) for i in want]


def camvid_pair(tmp_path, tf):
    from hyperseg_torch.data.camvid import CamVidDataset
    from hyperseg_tpu.data.camvid import CamVidDataset as JCamVid
    make_camvid_tree(tmp_path, n=5)
    return (CamVidDataset(str(tmp_path), "train", transforms=T.Compose(tf(T))),
            JCamVid(str(tmp_path), "train", transforms=JT.Compose(tf(JT))))


@pytest.mark.parametrize("mode", ["pad_last", "drop_last", "plain"])
def test_loader_batches_match_jax(tmp_path, mode):
    """The port's batches (CHW, uint8 labels) equal the JAX loader's
    transposed, with the same length; pad_last fills the last batch with
    copies of its last image labelled 255, drop_last drops it."""
    from hyperseg_torch.data.loader import DataLoader, RandomSampler
    from hyperseg_tpu.data.loader import DataLoader as JDataLoader, RandomSampler as JRandom
    port_ds, ref_ds = camvid_pair(tmp_path, lambda m: [m.ToArray(), m.Normalize()])
    kw = {"pad_last": dict(pad_last=True), "drop_last": dict(drop_last=True),
          "plain": {}}[mode]
    got = DataLoader(port_ds, batch_size=2, workers=0, **kw,
                     sampler=RandomSampler(port_ds, 7, seed=1) if mode == "plain" else None)
    want = JDataLoader(ref_ds, batch_size=2, workers=1, **kw,
                       sampler=JRandom(ref_ds, 7, seed=1) if mode == "plain" else None)
    got_b, want_b = list(got), list(want)
    assert len(got) == len(want) == len(got_b) == len(want_b) == {"pad_last": 3, "drop_last": 2,
                                                                  "plain": 4}[mode]
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(g["image"].numpy().transpose(0, 2, 3, 1), w["image"])
        assert g["label"].dtype == torch.uint8
        np.testing.assert_array_equal(g["label"].numpy().astype(np.int32), w["label"])
    if mode == "pad_last":
        assert (got_b[-1]["label"][1] == 255).all()
        np.testing.assert_array_equal(got_b[-1]["image"][1], got_b[-1]["image"][0])


def test_loader_collates_pyramids(tmp_path):
    from hyperseg_torch.data.loader import DataLoader
    port_ds, _ = camvid_pair(tmp_path, lambda m: [m.UpDownPyramids(2, 1), m.ToArray()])
    b = next(iter(DataLoader(port_ds, batch_size=2, workers=0)))
    assert [tuple(x.shape) for x in b["image"]] == [(2, 3, 32, 48), (2, 3, 16, 24),
                                                    (2, 3, 64, 96)]
    assert tuple(b["label"].shape) == (2, 32, 48)


def test_loader_worker_processes_and_their_seeds(tmp_path):
    """Two spawned workers give the in-process loader's batches under one
    seed (worker 0 draws batch 0's flips in both); each pass draws anew,
    and a new loader with the seed repeats the first pass."""
    from hyperseg_torch.data.loader import DataLoader
    port_ds, _ = camvid_pair(tmp_path, lambda m: [m.RandomHorizontalFlip(), m.ToArray()])

    def images(loader):
        return [b["image"] for b in loader]

    ref = DataLoader(port_ds, batch_size=5, workers=0, seed=3)
    first, second = images(ref), images(ref)
    again = images(DataLoader(port_ds, batch_size=5, workers=0, seed=3))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not all(torch.equal(a, b) for a, b in zip(first, second))
    procs = images(DataLoader(port_ds, batch_size=5, workers=2, seed=3))
    assert len(procs) == 1 and torch.equal(procs[0], first[0])


# --------------------------------------------------------------------------
# native host ops, archives
# --------------------------------------------------------------------------


def test_native_builds_into_its_build_dir():
    native.load()
    assert os.path.isfile(native.library_path())
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


def test_native_raises_when_it_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.load()
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        native.load()


@pytest.mark.parametrize("shape", [(64, 96), (1, 1), (37, 53)])
def test_native_ops_match_their_twins(shape):
    from hyperseg_tpu.data.camvid import CLASS_COLOR
    from hyperseg_tpu.data.cityscapes import ID_TO_TRAIN_ID
    rng = np.random.RandomState(shape[0])
    colors = np.asarray(CLASS_COLOR, np.uint8)
    rgb = colors[rng.randint(0, len(colors), shape)]
    rgb.reshape(-1, 3)[::7] = (9, 9, 9)  # unknown colour
    np.testing.assert_array_equal(native.rgb_label_to_index(rgb, colors, fill=255),
                                  native.rgb_label_to_index_plain(rgb, colors, fill=255))
    labels = rng.randint(0, 40, shape).astype(np.uint8)
    np.testing.assert_array_equal(native.map_labels(labels, ID_TO_TRAIN_ID, fill=7),
                                  native.map_labels_plain(labels, ID_TO_TRAIN_ID, fill=7))
    img = rng.randint(0, 256, (*shape, 3), np.uint8)
    got = native.normalize_u8(img, MEAN, STD)
    want = native.normalize_u8_plain(img, MEAN, STD)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_native_checks_its_arguments():
    with pytest.raises(ValueError, match="channels"):
        native.normalize_u8(np.zeros((2, 2, 9), np.uint8), 0.5, 0.5)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        native.rgb_label_to_index(np.zeros((2, 2), np.uint8), [(0, 0, 0)])


@pytest.mark.parametrize("kind", ["tar", "zip"])
def test_archive_extraction_refuses_traversal(tmp_path, kind):
    """Both extractors unpack a clean archive and refuse a member that
    climbs out of the destination, as the JAX package's do."""
    from hyperseg_torch.utils.archive import safe_extract_tar, safe_extract_zip
    from hyperseg_tpu.utils import download as J
    (tmp_path / "a.txt").write_text("x")
    for name, member in (("good", "d/a.txt"), ("bad", "../evil.txt")):
        path = tmp_path / f"{name}.{kind}"
        if kind == "tar":
            with tarfile.open(path, "w") as t:
                t.add(tmp_path / "a.txt", arcname=member)
        else:
            with zipfile.ZipFile(path, "w") as z:
                z.write(tmp_path / "a.txt", member)
        for fn in ((safe_extract_tar, J.safe_extract_tar) if kind == "tar"
                   else (safe_extract_zip, J.safe_extract_zip)):
            dest = tmp_path / f"out_{name}_{fn.__module__.split('.')[0]}"
            if name == "good":
                fn(str(path), str(dest))
                assert (dest / "d" / "a.txt").read_text() == "x"
            else:
                with pytest.raises(Exception):
                    fn(str(path), str(dest))
                assert not (tmp_path / "evil.txt").exists()


# --------------------------------------------------------------------------
# display helpers, metric classes, meters, registry
# --------------------------------------------------------------------------


def test_display_helpers_match_jax():
    from hyperseg_torch.utils import img_utils as U
    from hyperseg_tpu.utils import img_utils as JU
    rng = np.random.RandomState(0)
    x = rng.randn(3, 20, 30).astype(np.float32)
    seg = rng.randint(0, 12, (20, 30))
    seg[:3] = 255
    cmap = [(int(37 * i) % 256, int(91 * i) % 256, int(151 * i) % 256) for i in range(12)]
    base = U.denormalize(torch.from_numpy(x), MEAN, STD)
    jbase = JU.denormalize(x.transpose(1, 2, 0), MEAN, STD)
    np.testing.assert_array_equal(base.numpy().transpose(1, 2, 0), jbase)
    for ignore in (255, 0):
        got = U.blend_seg(base, torch.from_numpy(seg), cmap, 0.4, ignore_index=ignore)
        want = JU.blend_seg(jbase, seg, cmap, 0.4, ignore_index=ignore)
        np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), want)
    small = base[:, :12]
    got = U.make_grid(base, small, base)
    want = JU.make_grid(jbase, jbase[:12], jbase)
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), want)


def test_metric_classes_match_jax():
    from hyperseg_torch.utils.seg_utils import ConfusionMatrix, IOUBenchmark
    from hyperseg_tpu.utils.seg_utils import (ConfusionMatrix as JConfusionMatrix,
                                              IOUBenchmark as JIOUBenchmark)
    rng = np.random.RandomState(1)
    got, want = ConfusionMatrix(6, ignore_index=255), JConfusionMatrix(6, ignore_index=255)
    bench, jbench = IOUBenchmark(6), JIOUBenchmark(6)
    for _ in range(3):
        target = rng.randint(0, 6, (2, 9, 13))
        target[:, 0] = 255
        pred = rng.randint(0, 6, target.shape)
        got.update(torch.from_numpy(target), torch.from_numpy(pred))
        want.update(target, pred)
        assert bench(torch.from_numpy(pred), torch.from_numpy(target)) == \
            pytest.approx(jbench(pred, target), abs=0)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    for a, b in zip(got.compute(), want.compute()):
        np.testing.assert_array_equal(a, b)
    got.reset()
    assert got.mat.sum() == 0


def test_meters_and_logger_match_jax(tmp_path, monkeypatch):
    """AverageMeter, TensorBoardLogger's progress string and its JSONL file
    (what it writes without tensorboardX), and ProgressMeter's plain lines."""
    import builtins
    import io
    from hyperseg_torch.utils import logging as L
    from hyperseg_tpu.utils import logging as JL
    real_import = builtins.__import__

    def no_tensorboardx(name, *a, **k):
        if name == "tensorboardX":
            raise ImportError(name)
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_tensorboardx)
    loggers = [L.TensorBoardLogger(str(tmp_path / "port")),
               JL.TensorBoardLogger(str(tmp_path / "jax"))]
    for lg in loggers:
        lg.reset("epoch 1")
        for v in (1.0, 2.5, 0.5):
            lg.update("losses", total=v, ce=v / 2)
        lg.update("metrics", iou=0.25)
        lg.log_scalars_avg("train", 3)
    assert str(loggers[0]) == str(loggers[1])
    loggers[0].close()
    lines = [open(tmp_path / d / "metrics.jsonl").read().splitlines() for d in ("port", "jax")]
    strip = [[{k: v for k, v in __import__("json").loads(x).items() if k != "time"}
              for x in ls] for ls in lines]
    assert strip[0] == strip[1] and len(strip[0]) == 1
    m = L.AverageMeter()
    for v, n in ((2.0, 1), (4.0, 3)):
        m.update(v, n)
    assert (m.val, m.avg, m.count) == (4.0, 3.5, 4)
    out = io.StringIO()
    p = L.ProgressMeter(2, stream=out)
    p.set_description("eval")
    p.update(2)
    p.close()
    assert out.getvalue().splitlines()[0].startswith("eval | 0/2")
    assert "2/2" in out.getvalue().splitlines()[-1]


@pytest.mark.parametrize("target", [
    "seg_transforms.ImageResize", "cityscapes.CityscapesDataset", "camvid.CamVidDataset",
    "voc_sbd.VOCSBDDataset", "hyperseg.datasets.cityscapes.CityscapesDataset",
    "hyperseg.datasets.seg_transforms.ToTensor", "hyperseg_tpu.data.camvid.CamVidDataset",
    "hyperseg_tpu.data.voc_sbd.VOCSBDDataset",
    "hyperseg.losses.bootstrapped_ce_loss.BootstrappedCrossEntropyLoss",
    "hyperseg_tpu.train.losses.BootstrappedCrossEntropyLoss", "losses.softmax_cross_entropy",
    "hyperseg_tpu.train.schedule.poly_lr"])
def test_registry_resolves_data_and_loss_aliases_to_the_port(target):
    from hyperseg_torch.core import registry
    obj = registry.resolve_target(target)
    assert obj.__module__.startswith("hyperseg_torch."), obj.__module__
    spec = registry.parse_spec(f"{target.rsplit('.', 1)[0]}.{target.rsplit('.', 1)[1]}")
    assert registry.resolve_target(spec.target) is obj
