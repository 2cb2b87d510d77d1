"""Benchmark split definitions (sequence/scene identifiers).

The port's own copy of :mod:`bufferx_tpu.data.splits`.

Factual sequence lists for the 13 evaluation targets, equivalent to the
reference's ``config/splits/*.txt`` (all 11 files pinned here, including
the ScanNet++ iPhone/Faro scene lists and the ModelNet40 half-2 category
list). Loaders iterate the pinned lists; a missing pinned scene is a
loud warning (silent directory discovery would quietly change the
benchmark — see :func:`pinned_scenes`).
"""

from __future__ import annotations

import os
import warnings

KITTI = {
    "train": ["0", "1", "2", "3", "4", "5"],
    "val": ["6", "7"],
    "test": ["8", "9", "10"],
}

WOD_TEST = [
    "17792628511034220885_2360_000_2380_000",
    "18149616047892103767_2460_000_2480_000",
    "10980133015080705026_780_000_800_000",
    "2601205676330128831_4880_000_4900_000",
    "7247823803417339098_2320_000_2340_000",
    "14188689528137485670_2660_000_2680_000",
    "5026942594071056992_3120_000_3140_000",
    "5638240639308158118_4220_000_4240_000",
    "8688567562597583972_940_000_960_000",
    "4140965781175793864_460_000_480_000",
    "15272375112495403395_620_000_640_000",
    "11987368976578218644_1340_000_1360_000",
    "10504764403039842352_460_000_480_000",
    "8993680275027614595_2520_000_2540_000",
    "17136775999940024630_4860_000_4880_000",
    "14737335824319407706_1980_000_2000_000",
]

MIT_TEST = ["acl_jackal"]

OXFORD_TEST = [
    "01_short_experiments",
    "05_quad_with_dynamics",
    "07_parkland_mound",
]

KAIST_TEST = ["Avia", "Aeva", "Ouster"]

TIERS_TEST = [
    "tiers_indoor06",
    "tiers_indoor08",
    "tiers_indoor09",
    "tiers_indoor10",
    "tiers_indoor11",
]

THREEDMATCH_TEST_SCENES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]

ETH_TEST_SCENES = [
    "gazebo_summer",
    "gazebo_winter",
    "wood_autmn",
    "wood_summer",
]


# ScanNet++ benchmark scene ids (reference ``config/splits/test_scannetpp_iphone.txt`` /
# ``test_scannetpp_faro.txt``) — the pinned evaluation scene lists.
SCANNETPP_IPHONE_TEST = [
    "07ff1c45bb",
    "0a184cf634",
    "0a5c013435",
    "0a76e06478",
    "0a7cc12c0e",
    "0b031f3119",
    "0cf2e9402d",
    "0d2ee665be",
    "0e75f3c4d9",
    "1a130d092a",
    "1a8e0d78c0",
    "281ba69af1",
    "28a9ee4557",
    "4ba22fa7e4",
    "50809ea0d8",
    "55b2bf8036",
    "5656608266",
    "646af5e14b",
    "6855e1ac32",
    "7977624358",
    "8e00ac7f59",
]

SCANNETPP_FARO_TEST = [
    "02455b3d20",
    "036bce3393",
    "0529d56cce",
    "06a3d79b68",
    "076c822ecc",
    "079a326597",
    "07f5b601ee",
    "07ff1c45bb",
    "08bbbdcc3d",
    "09bced689e",
    "09c1414f1b",
    "0a184cf634",
    "0a5c013435",
    "0a76e06478",
    "0a7cc12c0e",
    "0b031f3119",
    "0cf2e9402d",
    "0d2ee665be",
    "0e75f3c4d9",
    "104acbf7d2",
    "108ec0b806",
    "116456116b",
    "1204e08f17",
    "13285009a4",
    "1366d5ae89",
    "13c3e046d7",
    "154c3e10d9",
    "16c9bd2e1e",
    "1831b3823a",
    "1841a0b525",
    "25927bb04c",
    "25f3b7a318",
    "260db9cf5a",
    "260fa55d50",
    "27dd4da69e",
    "280b83fcf3",
    "281ba69af1",
    "281bc17764",
    "285efbc7cf",
    "286b55a2bf",
    "28a9ee4557",
    "290ef3f2c9",
    "2970e95b65",
    "29b607c6d5",
    "2a1a3afad9",
    "2a496183e1",
    "2b1dc6d6a5",
    "2e67a32314",
    "2e74812d00",
    "302a7f6b67",
    "303745abc7",
    "30966f4c6e",
    "30f4a2b44d",
    "31a2c91c43",
    "320c3af000",
    "32280ecbca",
    "324d07a5b3",
    "355e5e32db",
    "37ea1c52f0",
    "3864514494",
    "38d58a7a31",
    "3928249b53",
    "394a542a19",
    "39e6ee46df",
    "39f36da05b",
    "3a161a857d",
    "3c95c89d61",
    "3db0a1c8f3",
    "3e6ceea56c",
    "3e8bba0176",
    "3e928dc2f6",
    "3f15a9266d",
    "3f1e1610de",
    "40aec5fffa",
    "40b56bf310",
    "410c470782",
    "419cbe7c11",
    "41b00feddb",
    "4318f8bb3c",
    "4422722c49",
    "45b0dac5e3",
    "45d2e33be1",
    "47b37eb6f9",
    "47eb87b5bb",
    "480ddaadc0",
    "484ad681df",
    "497588b572",
    "49a82360aa",
    "4a1a3a7dc5",
    "4ba22fa7e4",
    "4c5c60fa76",
    "4ea827f5a1",
    "4ef75031e3",
    "50809ea0d8",
    "52599ae063",
    "5371eff4f9",
    "54b6127146",
    "54bca9597e",
    "55b2bf8036",
    "5654092cc2",
    "5656608266",
    "569f99f881",
    "56a0ec536c",
    "5748ce6f01",
    "578511c8a9",
    "5942004064",
    "59e3f1ea37",
    "5a269ba6fe",
    "5d152fab1b",
    "5eb31827b7",
    "5ee7c22ba0",
    "5f99900f09",
    "5fb5d2dbf2",
    "6115eddb86",
    "61adeff7d5",
    "6464461276",
    "646af5e14b",
    "66c98f4a9b",
    "67d702f2e8",
    "6855e1ac32",
    "68739bdf1f",
    "689fec23d7",
    "69e5939669",
    "6b40d1a939",
    "6cc2231b9c",
    "6d89a7320d",
    "6ebe30292e",
    "6ee2fc1070",
    "6f12492455",
    "6f1848d1e3",
    "7079b59642",
    "709ab5bffe",
    "712dc47104",
    "728daff2a3",
    "75d29d69b8",
    "7831862f02",
    "785e7504b9",
    "7977624358",
    "7b6477cb95",
    "7bc286c1b6",
    "7cd2ac43b4",
    "7dfdff1b7d",
    "7e09430da7",
    "7e7cd69a59",
    "7eac902fd5",
    "7f4d173c9c",
    "7ffc86edf4",
    "80ffca8a48",
    "8133208cb6",
    "824d9cfa6e",
    "825d228aec",
    "85251de7d1",
    "87f6d7d564",
    "88627b561e",
    "8890d0a267",
    "88cf747085",
    "89214f3ca0",
    "893fb90e89",
    "8a20d62ac0",
    "8a35ef3cfe",
    "8b2c0938d6",
    "8b5caf3398",
    "8be0cd3817",
]

# ModelNet40 held-out category half used for zero-shot pair synthesis
# (reference ``config/splits/modelnet40_half2.txt``).
MODELNET40_HALF2_CATEGORIES = [
    "laptop",
    "mantel",
    "monitor",
    "night_stand",
    "person",
    "piano",
    "plant",
    "radio",
    "range_hood",
    "sink",
    "sofa",
    "stairs",
    "stool",
    "table",
    "tent",
    "toilet",
    "tv_stand",
    "vase",
    "wardrobe",
    "xbox",
]



def pinned_scenes(root: str, pinned: list, what: str) -> list:
    """The pinned scene list, validated against a dataset root.

    Returns the pinned scenes that exist under ``root``. Missing pinned
    scenes trigger a LOUD warning naming them (an eval over a subset is a
    different benchmark and must not pass silently). If NONE of the pinned
    scenes are present, falls back to directory discovery — also loudly —
    so locally-generated layouts remain usable.
    """
    try:
        present = set(os.listdir(root))
    except OSError:
        present = set()
    have = [s for s in pinned if s in present]
    missing = [s for s in pinned if s not in present]
    if have and missing:
        warnings.warn(
            f"{what}: {len(missing)}/{len(pinned)} pinned benchmark scenes "
            f"missing under {root!r}: {missing[:8]}{'...' if len(missing) > 8 else ''} "
            "— results are NOT the pinned benchmark.",
            stacklevel=2,
        )
    if not have:
        discovered = sorted(present)
        if discovered:
            warnings.warn(
                f"{what}: no pinned benchmark scene found under {root!r}; "
                f"falling back to directory discovery ({len(discovered)} "
                "entries) — results are NOT the pinned benchmark.",
                stacklevel=2,
            )
        return discovered
    return have
