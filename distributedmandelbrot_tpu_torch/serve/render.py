"""The colormap core (escape values -> RGBA, RGBA -> PNG bytes) and the
gateway's server-side tile rendering to palette PNGs.

The port of the JAX package's ``serve/render.py``, without matplotlib:
the machines the port runs on need not have it.  The port carries the
data of the three colormaps the wire registry names
(``net/protocol.py`` ``COLORMAPS``): matplotlib's ``jet`` segment data,
whose 256-entry lookup table it builds the way
``LinearSegmentedColormap`` does, and the 256 listed colors of
``viridis`` and ``plasma``.  Floats map to table rows the way
``Colormap.__call__`` maps them, so the colors are matplotlib's, bit for
bit.  The pipeline is the reference viewer's: normalise, invert, apply
the colormap, paint in-set pixels black.

Two float-to-byte steps, kept apart as in the JAX package:
:func:`imsave_bytes` is the one ``plt.imsave`` applies to a float RGBA
image (truncation), which the CLI's PNGs (:func:`encode_png`) follow;
:func:`to_rgba8` rounds half up, which the gateway's palette PNGs
(:func:`render_tile_png`, :func:`value_lut`) follow.

A smooth view bound for a PNG can skip the float RGBA plane:
``smooth_to_rgba(..., rgba8_on=device)`` colours it on ``device``
straight to the bytes :func:`imsave_bytes` would store, through tables
built from the float route's own arithmetic (:func:`smooth_boundaries`,
:func:`smooth_table8`; the kernel of ``ops/cuda_colormap.py`` on a
card).

A large PNG is deflated in bands of rows on the host's cores
(:func:`encode_png`), into one zlib stream whose bytes follow the image
alone.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs import phases

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# matplotlib's ``jet`` (``matplotlib._cm._jet_data``): per channel, rows
# of (x, y below x, y above x).
JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
# matplotlib's ``viridis`` and ``plasma`` (``matplotlib._cm_listed``):
# 256 listed RGB colors each.
VIRIDIS_DATA = (
    (0.267004, 0.004874, 0.329415), (0.26851, 0.009605, 0.335427),
    (0.269944, 0.014625, 0.341379), (0.271305, 0.019942, 0.347269),
    (0.272594, 0.025563, 0.353093), (0.273809, 0.031497, 0.358853),
    (0.274952, 0.037752, 0.364543), (0.276022, 0.044167, 0.370164),
    (0.277018, 0.050344, 0.375715), (0.277941, 0.056324, 0.381191),
    (0.278791, 0.062145, 0.386592), (0.279566, 0.067836, 0.391917),
    (0.280267, 0.073417, 0.397163), (0.280894, 0.078907, 0.402329),
    (0.281446, 0.08432, 0.407414), (0.281924, 0.089666, 0.412415),
    (0.282327, 0.094955, 0.417331), (0.282656, 0.100196, 0.42216),
    (0.28291, 0.105393, 0.426902), (0.283091, 0.110553, 0.431554),
    (0.283197, 0.11568, 0.436115), (0.283229, 0.120777, 0.440584),
    (0.283187, 0.125848, 0.44496), (0.283072, 0.130895, 0.449241),
    (0.282884, 0.13592, 0.453427), (0.282623, 0.140926, 0.457517),
    (0.28229, 0.145912, 0.46151), (0.281887, 0.150881, 0.465405),
    (0.281412, 0.155834, 0.469201), (0.280868, 0.160771, 0.472899),
    (0.280255, 0.165693, 0.476498), (0.279574, 0.170599, 0.479997),
    (0.278826, 0.17549, 0.483397), (0.278012, 0.180367, 0.486697),
    (0.277134, 0.185228, 0.489898), (0.276194, 0.190074, 0.493001),
    (0.275191, 0.194905, 0.496005), (0.274128, 0.199721, 0.498911),
    (0.273006, 0.20452, 0.501721), (0.271828, 0.209303, 0.504434),
    (0.270595, 0.214069, 0.507052), (0.269308, 0.218818, 0.509577),
    (0.267968, 0.223549, 0.512008), (0.26658, 0.228262, 0.514349),
    (0.265145, 0.232956, 0.516599), (0.263663, 0.237631, 0.518762),
    (0.262138, 0.242286, 0.520837), (0.260571, 0.246922, 0.522828),
    (0.258965, 0.251537, 0.524736), (0.257322, 0.25613, 0.526563),
    (0.255645, 0.260703, 0.528312), (0.253935, 0.265254, 0.529983),
    (0.252194, 0.269783, 0.531579), (0.250425, 0.27429, 0.533103),
    (0.248629, 0.278775, 0.534556), (0.246811, 0.283237, 0.535941),
    (0.244972, 0.287675, 0.53726), (0.243113, 0.292092, 0.538516),
    (0.241237, 0.296485, 0.539709), (0.239346, 0.300855, 0.540844),
    (0.237441, 0.305202, 0.541921), (0.235526, 0.309527, 0.542944),
    (0.233603, 0.313828, 0.543914), (0.231674, 0.318106, 0.544834),
    (0.229739, 0.322361, 0.545706), (0.227802, 0.326594, 0.546532),
    (0.225863, 0.330805, 0.547314), (0.223925, 0.334994, 0.548053),
    (0.221989, 0.339161, 0.548752), (0.220057, 0.343307, 0.549413),
    (0.21813, 0.347432, 0.550038), (0.21621, 0.351535, 0.550627),
    (0.214298, 0.355619, 0.551184), (0.212395, 0.359683, 0.55171),
    (0.210503, 0.363727, 0.552206), (0.208623, 0.367752, 0.552675),
    (0.206756, 0.371758, 0.553117), (0.204903, 0.375746, 0.553533),
    (0.203063, 0.379716, 0.553925), (0.201239, 0.38367, 0.554294),
    (0.19943, 0.387607, 0.554642), (0.197636, 0.391528, 0.554969),
    (0.19586, 0.395433, 0.555276), (0.1941, 0.399323, 0.555565),
    (0.192357, 0.403199, 0.555836), (0.190631, 0.407061, 0.556089),
    (0.188923, 0.41091, 0.556326), (0.187231, 0.414746, 0.556547),
    (0.185556, 0.41857, 0.556753), (0.183898, 0.422383, 0.556944),
    (0.182256, 0.426184, 0.55712), (0.180629, 0.429975, 0.557282),
    (0.179019, 0.433756, 0.55743), (0.177423, 0.437527, 0.557565),
    (0.175841, 0.44129, 0.557685), (0.174274, 0.445044, 0.557792),
    (0.172719, 0.448791, 0.557885), (0.171176, 0.45253, 0.557965),
    (0.169646, 0.456262, 0.55803), (0.168126, 0.459988, 0.558082),
    (0.166617, 0.463708, 0.558119), (0.165117, 0.467423, 0.558141),
    (0.163625, 0.471133, 0.558148), (0.162142, 0.474838, 0.55814),
    (0.160665, 0.47854, 0.558115), (0.159194, 0.482237, 0.558073),
    (0.157729, 0.485932, 0.558013), (0.15627, 0.489624, 0.557936),
    (0.154815, 0.493313, 0.55784), (0.153364, 0.497, 0.557724),
    (0.151918, 0.500685, 0.557587), (0.150476, 0.504369, 0.55743),
    (0.149039, 0.508051, 0.55725), (0.147607, 0.511733, 0.557049),
    (0.14618, 0.515413, 0.556823), (0.144759, 0.519093, 0.556572),
    (0.143343, 0.522773, 0.556295), (0.141935, 0.526453, 0.555991),
    (0.140536, 0.530132, 0.555659), (0.139147, 0.533812, 0.555298),
    (0.13777, 0.537492, 0.554906), (0.136408, 0.541173, 0.554483),
    (0.135066, 0.544853, 0.554029), (0.133743, 0.548535, 0.553541),
    (0.132444, 0.552216, 0.553018), (0.131172, 0.555899, 0.552459),
    (0.129933, 0.559582, 0.551864), (0.128729, 0.563265, 0.551229),
    (0.127568, 0.566949, 0.550556), (0.126453, 0.570633, 0.549841),
    (0.125394, 0.574318, 0.549086), (0.124395, 0.578002, 0.548287),
    (0.123463, 0.581687, 0.547445), (0.122606, 0.585371, 0.546557),
    (0.121831, 0.589055, 0.545623), (0.121148, 0.592739, 0.544641),
    (0.120565, 0.596422, 0.543611), (0.120092, 0.600104, 0.54253),
    (0.119738, 0.603785, 0.5414), (0.119512, 0.607464, 0.540218),
    (0.119423, 0.611141, 0.538982), (0.119483, 0.614817, 0.537692),
    (0.119699, 0.61849, 0.536347), (0.120081, 0.622161, 0.534946),
    (0.120638, 0.625828, 0.533488), (0.12138, 0.629492, 0.531973),
    (0.122312, 0.633153, 0.530398), (0.123444, 0.636809, 0.528763),
    (0.12478, 0.640461, 0.527068), (0.126326, 0.644107, 0.525311),
    (0.128087, 0.647749, 0.523491), (0.130067, 0.651384, 0.521608),
    (0.132268, 0.655014, 0.519661), (0.134692, 0.658636, 0.517649),
    (0.137339, 0.662252, 0.515571), (0.14021, 0.665859, 0.513427),
    (0.143303, 0.669459, 0.511215), (0.146616, 0.67305, 0.508936),
    (0.150148, 0.676631, 0.506589), (0.153894, 0.680203, 0.504172),
    (0.157851, 0.683765, 0.501686), (0.162016, 0.687316, 0.499129),
    (0.166383, 0.690856, 0.496502), (0.170948, 0.694384, 0.493803),
    (0.175707, 0.6979, 0.491033), (0.180653, 0.701402, 0.488189),
    (0.185783, 0.704891, 0.485273), (0.19109, 0.708366, 0.482284),
    (0.196571, 0.711827, 0.479221), (0.202219, 0.715272, 0.476084),
    (0.20803, 0.718701, 0.472873), (0.214, 0.722114, 0.469588),
    (0.220124, 0.725509, 0.466226), (0.226397, 0.728888, 0.462789),
    (0.232815, 0.732247, 0.459277), (0.239374, 0.735588, 0.455688),
    (0.24607, 0.73891, 0.452024), (0.252899, 0.742211, 0.448284),
    (0.259857, 0.745492, 0.444467), (0.266941, 0.748751, 0.440573),
    (0.274149, 0.751988, 0.436601), (0.281477, 0.755203, 0.432552),
    (0.288921, 0.758394, 0.428426), (0.296479, 0.761561, 0.424223),
    (0.304148, 0.764704, 0.419943), (0.311925, 0.767822, 0.415586),
    (0.319809, 0.770914, 0.411152), (0.327796, 0.77398, 0.40664),
    (0.335885, 0.777018, 0.402049), (0.344074, 0.780029, 0.397381),
    (0.35236, 0.783011, 0.392636), (0.360741, 0.785964, 0.387814),
    (0.369214, 0.788888, 0.382914), (0.377779, 0.791781, 0.377939),
    (0.386433, 0.794644, 0.372886), (0.395174, 0.797475, 0.367757),
    (0.404001, 0.800275, 0.362552), (0.412913, 0.803041, 0.357269),
    (0.421908, 0.805774, 0.35191), (0.430983, 0.808473, 0.346476),
    (0.440137, 0.811138, 0.340967), (0.449368, 0.813768, 0.335384),
    (0.458674, 0.816363, 0.329727), (0.468053, 0.818921, 0.323998),
    (0.477504, 0.821444, 0.318195), (0.487026, 0.823929, 0.312321),
    (0.496615, 0.826376, 0.306377), (0.506271, 0.828786, 0.300362),
    (0.515992, 0.831158, 0.294279), (0.525776, 0.833491, 0.288127),
    (0.535621, 0.835785, 0.281908), (0.545524, 0.838039, 0.275626),
    (0.555484, 0.840254, 0.269281), (0.565498, 0.84243, 0.262877),
    (0.575563, 0.844566, 0.256415), (0.585678, 0.846661, 0.249897),
    (0.595839, 0.848717, 0.243329), (0.606045, 0.850733, 0.236712),
    (0.616293, 0.852709, 0.230052), (0.626579, 0.854645, 0.223353),
    (0.636902, 0.856542, 0.21662), (0.647257, 0.8584, 0.209861),
    (0.657642, 0.860219, 0.203082), (0.668054, 0.861999, 0.196293),
    (0.678489, 0.863742, 0.189503), (0.688944, 0.865448, 0.182725),
    (0.699415, 0.867117, 0.175971), (0.709898, 0.868751, 0.169257),
    (0.720391, 0.87035, 0.162603), (0.730889, 0.871916, 0.156029),
    (0.741388, 0.873449, 0.149561), (0.751884, 0.874951, 0.143228),
    (0.762373, 0.876424, 0.137064), (0.772852, 0.877868, 0.131109),
    (0.783315, 0.879285, 0.125405), (0.79376, 0.880678, 0.120005),
    (0.804182, 0.882046, 0.114965), (0.814576, 0.883393, 0.110347),
    (0.82494, 0.88472, 0.106217), (0.83527, 0.886029, 0.102646),
    (0.845561, 0.887322, 0.099702), (0.85581, 0.888601, 0.097452),
    (0.866013, 0.889868, 0.095953), (0.876168, 0.891125, 0.09525),
    (0.886271, 0.892374, 0.095374), (0.89632, 0.893616, 0.096335),
    (0.906311, 0.894855, 0.098125), (0.916242, 0.896091, 0.100717),
    (0.926106, 0.89733, 0.104071), (0.935904, 0.89857, 0.108131),
    (0.945636, 0.899815, 0.112838), (0.9553, 0.901065, 0.118128),
    (0.964894, 0.902323, 0.123941), (0.974417, 0.90359, 0.130215),
    (0.983868, 0.904867, 0.136897), (0.993248, 0.906157, 0.143936),
)
PLASMA_DATA = (
    (0.050383, 0.029803, 0.527975), (0.063536, 0.028426, 0.533124),
    (0.075353, 0.027206, 0.538007), (0.086222, 0.026125, 0.542658),
    (0.096379, 0.025165, 0.547103), (0.10598, 0.024309, 0.551368),
    (0.115124, 0.023556, 0.555468), (0.123903, 0.022878, 0.559423),
    (0.132381, 0.022258, 0.56325), (0.140603, 0.021687, 0.566959),
    (0.148607, 0.021154, 0.570562), (0.156421, 0.020651, 0.574065),
    (0.16407, 0.020171, 0.577478), (0.171574, 0.019706, 0.580806),
    (0.17895, 0.019252, 0.584054), (0.186213, 0.018803, 0.587228),
    (0.193374, 0.018354, 0.59033), (0.200445, 0.017902, 0.593364),
    (0.207435, 0.017442, 0.596333), (0.21435, 0.016973, 0.599239),
    (0.221197, 0.016497, 0.602083), (0.227983, 0.016007, 0.604867),
    (0.234715, 0.015502, 0.607592), (0.241396, 0.014979, 0.610259),
    (0.248032, 0.014439, 0.612868), (0.254627, 0.013882, 0.615419),
    (0.261183, 0.013308, 0.617911), (0.267703, 0.012716, 0.620346),
    (0.274191, 0.012109, 0.622722), (0.280648, 0.011488, 0.625038),
    (0.287076, 0.010855, 0.627295), (0.293478, 0.010213, 0.62949),
    (0.299855, 0.009561, 0.631624), (0.30621, 0.008902, 0.633694),
    (0.312543, 0.008239, 0.6357), (0.318856, 0.007576, 0.63764),
    (0.32515, 0.006915, 0.639512), (0.331426, 0.006261, 0.641316),
    (0.337683, 0.005618, 0.643049), (0.343925, 0.004991, 0.64471),
    (0.35015, 0.004382, 0.646298), (0.356359, 0.003798, 0.64781),
    (0.362553, 0.003243, 0.649245), (0.368733, 0.002724, 0.650601),
    (0.374897, 0.002245, 0.651876), (0.381047, 0.001814, 0.653068),
    (0.387183, 0.001434, 0.654177), (0.393304, 0.001114, 0.655199),
    (0.399411, 0.000859, 0.656133), (0.405503, 0.000678, 0.656977),
    (0.41158, 0.000577, 0.65773), (0.417642, 0.000564, 0.65839),
    (0.423689, 0.000646, 0.658956), (0.429719, 0.000831, 0.659425),
    (0.435734, 0.001127, 0.659797), (0.441732, 0.00154, 0.660069),
    (0.447714, 0.00208, 0.66024), (0.453677, 0.002755, 0.66031),
    (0.459623, 0.003574, 0.660277), (0.46555, 0.004545, 0.660139),
    (0.471457, 0.005678, 0.659897), (0.477344, 0.00698, 0.659549),
    (0.48321, 0.00846, 0.659095), (0.489055, 0.010127, 0.658534),
    (0.494877, 0.01199, 0.657865), (0.500678, 0.014055, 0.657088),
    (0.506454, 0.016333, 0.656202), (0.512206, 0.018833, 0.655209),
    (0.517933, 0.021563, 0.654109), (0.523633, 0.024532, 0.652901),
    (0.529306, 0.027747, 0.651586), (0.534952, 0.031217, 0.650165),
    (0.54057, 0.03495, 0.64864), (0.546157, 0.038954, 0.64701),
    (0.551715, 0.043136, 0.645277), (0.557243, 0.047331, 0.643443),
    (0.562738, 0.051545, 0.641509), (0.568201, 0.055778, 0.639477),
    (0.573632, 0.060028, 0.637349), (0.579029, 0.064296, 0.635126),
    (0.584391, 0.068579, 0.632812), (0.589719, 0.072878, 0.630408),
    (0.595011, 0.07719, 0.627917), (0.600266, 0.081516, 0.625342),
    (0.605485, 0.085854, 0.622686), (0.610667, 0.090204, 0.619951),
    (0.615812, 0.094564, 0.61714), (0.620919, 0.098934, 0.614257),
    (0.625987, 0.103312, 0.611305), (0.631017, 0.107699, 0.608287),
    (0.636008, 0.112092, 0.605205), (0.640959, 0.116492, 0.602065),
    (0.645872, 0.120898, 0.598867), (0.650746, 0.125309, 0.595617),
    (0.65558, 0.129725, 0.592317), (0.660374, 0.134144, 0.588971),
    (0.665129, 0.138566, 0.585582), (0.669845, 0.142992, 0.582154),
    (0.674522, 0.147419, 0.578688), (0.67916, 0.151848, 0.575189),
    (0.683758, 0.156278, 0.57166), (0.688318, 0.160709, 0.568103),
    (0.69284, 0.165141, 0.564522), (0.697324, 0.169573, 0.560919),
    (0.701769, 0.174005, 0.557296), (0.706178, 0.178437, 0.553657),
    (0.710549, 0.182868, 0.550004), (0.714883, 0.187299, 0.546338),
    (0.719181, 0.191729, 0.542663), (0.723444, 0.196158, 0.538981),
    (0.72767, 0.200586, 0.535293), (0.731862, 0.205013, 0.531601),
    (0.736019, 0.209439, 0.527908), (0.740143, 0.213864, 0.524216),
    (0.744232, 0.218288, 0.520524), (0.748289, 0.222711, 0.516834),
    (0.752312, 0.227133, 0.513149), (0.756304, 0.231555, 0.509468),
    (0.760264, 0.235976, 0.505794), (0.764193, 0.240396, 0.502126),
    (0.76809, 0.244817, 0.498465), (0.771958, 0.249237, 0.494813),
    (0.775796, 0.253658, 0.491171), (0.779604, 0.258078, 0.487539),
    (0.783383, 0.2625, 0.483918), (0.787133, 0.266922, 0.480307),
    (0.790855, 0.271345, 0.476706), (0.794549, 0.27577, 0.473117),
    (0.798216, 0.280197, 0.469538), (0.801855, 0.284626, 0.465971),
    (0.805467, 0.289057, 0.462415), (0.809052, 0.293491, 0.45887),
    (0.812612, 0.297928, 0.455338), (0.816144, 0.302368, 0.451816),
    (0.819651, 0.306812, 0.448306), (0.823132, 0.311261, 0.444806),
    (0.826588, 0.315714, 0.441316), (0.830018, 0.320172, 0.437836),
    (0.833422, 0.324635, 0.434366), (0.836801, 0.329105, 0.430905),
    (0.840155, 0.33358, 0.427455), (0.843484, 0.338062, 0.424013),
    (0.846788, 0.342551, 0.420579), (0.850066, 0.347048, 0.417153),
    (0.853319, 0.351553, 0.413734), (0.856547, 0.356066, 0.410322),
    (0.85975, 0.360588, 0.406917), (0.862927, 0.365119, 0.403519),
    (0.866078, 0.36966, 0.400126), (0.869203, 0.374212, 0.396738),
    (0.872303, 0.378774, 0.393355), (0.875376, 0.383347, 0.389976),
    (0.878423, 0.387932, 0.3866), (0.881443, 0.392529, 0.383229),
    (0.884436, 0.397139, 0.37986), (0.887402, 0.401762, 0.376494),
    (0.89034, 0.406398, 0.37313), (0.89325, 0.411048, 0.369768),
    (0.896131, 0.415712, 0.366407), (0.898984, 0.420392, 0.363047),
    (0.901807, 0.425087, 0.359688), (0.904601, 0.429797, 0.356329),
    (0.907365, 0.434524, 0.35297), (0.910098, 0.439268, 0.34961),
    (0.9128, 0.444029, 0.346251), (0.915471, 0.448807, 0.34289),
    (0.918109, 0.453603, 0.339529), (0.920714, 0.458417, 0.336166),
    (0.923287, 0.463251, 0.332801), (0.925825, 0.468103, 0.329435),
    (0.928329, 0.472975, 0.326067), (0.930798, 0.477867, 0.322697),
    (0.933232, 0.48278, 0.319325), (0.93563, 0.487712, 0.315952),
    (0.93799, 0.492667, 0.312575), (0.940313, 0.497642, 0.309197),
    (0.942598, 0.502639, 0.305816), (0.944844, 0.507658, 0.302433),
    (0.947051, 0.512699, 0.299049), (0.949217, 0.517763, 0.295662),
    (0.951344, 0.52285, 0.292275), (0.953428, 0.52796, 0.288883),
    (0.95547, 0.533093, 0.28549), (0.957469, 0.53825, 0.282096),
    (0.959424, 0.543431, 0.278701), (0.961336, 0.548636, 0.275305),
    (0.963203, 0.553865, 0.271909), (0.965024, 0.559118, 0.268513),
    (0.966798, 0.564396, 0.265118), (0.968526, 0.5697, 0.261721),
    (0.970205, 0.575028, 0.258325), (0.971835, 0.580382, 0.254931),
    (0.973416, 0.585761, 0.25154), (0.974947, 0.591165, 0.248151),
    (0.976428, 0.596595, 0.244767), (0.977856, 0.602051, 0.241387),
    (0.979233, 0.607532, 0.238013), (0.980556, 0.613039, 0.234646),
    (0.981826, 0.618572, 0.231287), (0.983041, 0.624131, 0.227937),
    (0.984199, 0.629718, 0.224595), (0.985301, 0.63533, 0.221265),
    (0.986345, 0.640969, 0.217948), (0.987332, 0.646633, 0.214648),
    (0.98826, 0.652325, 0.211364), (0.989128, 0.658043, 0.2081),
    (0.989935, 0.663787, 0.204859), (0.990681, 0.669558, 0.201642),
    (0.991365, 0.675355, 0.198453), (0.991985, 0.681179, 0.195295),
    (0.992541, 0.68703, 0.19217), (0.993032, 0.692907, 0.189084),
    (0.993456, 0.69881, 0.186041), (0.993814, 0.704741, 0.183043),
    (0.994103, 0.710698, 0.180097), (0.994324, 0.716681, 0.177208),
    (0.994474, 0.722691, 0.174381), (0.994553, 0.728728, 0.171622),
    (0.994561, 0.734791, 0.168938), (0.994495, 0.74088, 0.166335),
    (0.994355, 0.746995, 0.163821), (0.994141, 0.753137, 0.161404),
    (0.993851, 0.759304, 0.159092), (0.993482, 0.765499, 0.156891),
    (0.993033, 0.77172, 0.154808), (0.992505, 0.777967, 0.152855),
    (0.991897, 0.784239, 0.151042), (0.991209, 0.790537, 0.149377),
    (0.990439, 0.796859, 0.14787), (0.989587, 0.803205, 0.146529),
    (0.988648, 0.809579, 0.145357), (0.987621, 0.815978, 0.144363),
    (0.986509, 0.822401, 0.143557), (0.985314, 0.828846, 0.142945),
    (0.984031, 0.835315, 0.142528), (0.982653, 0.841812, 0.142303),
    (0.98119, 0.848329, 0.142279), (0.979644, 0.854866, 0.142453),
    (0.977995, 0.861432, 0.142808), (0.976265, 0.868016, 0.143351),
    (0.974443, 0.874622, 0.144061), (0.97253, 0.88125, 0.144923),
    (0.970533, 0.887896, 0.145919), (0.968443, 0.894564, 0.147014),
    (0.966271, 0.901249, 0.14818), (0.964021, 0.90795, 0.14937),
    (0.961681, 0.914672, 0.15052), (0.959276, 0.921407, 0.151566),
    (0.956808, 0.928152, 0.152409), (0.954287, 0.934908, 0.152921),
    (0.951726, 0.941671, 0.152925), (0.949151, 0.948435, 0.152178),
    (0.946602, 0.95519, 0.150328), (0.944152, 0.961916, 0.146861),
    (0.941896, 0.96859, 0.140956), (0.940015, 0.975158, 0.131326),
)
# The colormaps the port carries, by name: segment data, or listed
# colors.
SEGMENTS = {"jet": JET_SEGMENTS}
LISTED = {"viridis": VIRIDIS_DATA, "plasma": PLASMA_DATA}
COLORMAPS = (*SEGMENTS, *LISTED)
# Table rows of a colormap (matplotlib's default N).
LUT_SIZE = 256

_LOCK = threading.Lock()
_TABLES: dict[str, np.ndarray] = {}
_VALUE_TABLES: dict[str, np.ndarray] = {}
_LUTS: dict[str, np.ndarray] = {}
_BOUNDARIES: dict[int, np.ndarray] = {}
_TABLES8: dict[str, np.ndarray] = {}


def _segment_lut(n: int, data) -> np.ndarray:
    """One channel's ``n``-entry table from its segment rows:
    matplotlib's ``_create_lookup_table`` at gamma 1."""
    adata = np.array(data)
    x = adata[:, 0] * (n - 1)
    y0 = adata[:, 1]
    y1 = adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap_table(colormap: str) -> np.ndarray:
    """(LUT_SIZE + 3, 4) float RGBA rows: the table, then the colors for
    values under the range, over it, and NaN (matplotlib's defaults: the
    end colors, and transparent black)."""
    with _LOCK:
        table = _TABLES.get(colormap)
        if table is None:
            if colormap not in COLORMAPS:
                raise ValueError(
                    f"colormap {colormap!r} is not carried by the port; "
                    f"it has {sorted(COLORMAPS)}")
            table = np.ones((LUT_SIZE + 3, 4), float)
            if colormap in LISTED:
                table[:-3, :3] = LISTED[colormap]
            else:
                seg = SEGMENTS[colormap]
                for ch, name in enumerate(("red", "green", "blue")):
                    table[:-3, ch] = _segment_lut(LUT_SIZE, seg[name])
            table[LUT_SIZE] = table[0]
            table[LUT_SIZE + 1] = table[LUT_SIZE - 1]
            table[LUT_SIZE + 2] = (0.0, 0.0, 0.0, 0.0)
            table.setflags(write=False)
            _TABLES[colormap] = table
        return table


def _table_rows(x: np.ndarray) -> np.ndarray:
    """Table rows of float values, as ``Colormap.__call__`` maps floats:
    ``x*N`` truncated to a row, ``x == 1`` to the last row, values under
    or over the range to the end colors' rows, NaN to the "bad" row."""
    xa = np.array(x, dtype=float, copy=True)
    xa *= LUT_SIZE
    xa[xa == LUT_SIZE] = LUT_SIZE - 1
    under = xa < 0
    over = xa >= LUT_SIZE
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = LUT_SIZE
    idx[over] = LUT_SIZE + 1
    idx[bad] = LUT_SIZE + 2
    return idx


def apply_colormap(x: np.ndarray, colormap: str = "jet") -> np.ndarray:
    """Float values in [0, 1] -> float RGBA through the rows of
    :func:`_table_rows`."""
    return colormap_table(colormap).take(_table_rows(x), axis=0, mode="clip")


def _masked_colormap(vs: np.ndarray, in_set: np.ndarray,
                     colormap: str) -> np.ndarray:
    """Shared tail of both render paths: colormap ``vs``, paint in-set
    pixels black."""
    mapped = apply_colormap(vs, colormap)
    black = np.array((0.0, 0.0, 0.0, 1.0))
    return np.where(in_set[..., None], black, mapped)


def _value_table(colormap: str) -> np.ndarray:
    """(256, 4) float RGBA of every uint8 value under
    :func:`value_to_rgba`: the pipeline is pointwise, so indexing this
    table gives the same floats as mapping a whole plane."""
    with _LOCK:
        table = _VALUE_TABLES.get(colormap)
    if table is None:
        vs = 1.0 - np.arange(256, dtype=float) / 256.0
        table = _masked_colormap(vs, vs == 1.0, colormap)
        table.setflags(write=False)
        with _LOCK:
            _VALUE_TABLES[colormap] = table
    return table


def value_to_rgba(values: np.ndarray, colormap: str = "jet") -> np.ndarray:
    """Flat (square) or 2-D uint8 values -> float RGBA array (reference
    pipeline: ``1 - v/256`` through the colormap, value 0 black)."""
    values = np.asarray(values)
    if values.ndim == 1:
        side = int(round(values.size ** 0.5))
        if side * side != values.size:
            raise ValueError(f"cannot square-reshape {values.size} pixels")
        values = values.reshape((side, side))
    if values.dtype == np.uint8:
        return _value_table(colormap)[values]
    vs = 1.0 - values.astype(float) / 256.0
    return _masked_colormap(vs, vs == 1.0, colormap)


def _smooth_scale(nu: np.ndarray, max_iter: int,
                  normalize: bool = False) -> np.ndarray:
    """The colormap's input for smooth values: ``1 - log1p(nu) /
    log1p(max_iter)`` clipped to [0, 1] (the inverted log scale), or
    with ``normalize`` the view's own escaped range stretched over it."""
    logs = np.log1p(np.maximum(nu, 0.0))
    escaped = nu > 0.0
    if normalize and escaped.any():
        sel = logs[escaped]
        lo, hi = float(sel.min()), float(sel.max())
        vs = (logs - lo) / max(hi - lo, 1e-12)
    else:
        vs = logs / np.log1p(float(max_iter))
    return 1.0 - np.clip(vs, 0.0, 1.0)


def smooth_to_rgba(nu: np.ndarray, max_iter: int, colormap: str = "jet",
                   normalize: bool = False, *, rgba8_on=None) -> np.ndarray:
    """Continuous escape values -> RGBA: in-set (0) pixels black, others
    through the inverted colormap on a log scale (``log1p(nu) /
    log1p(max_iter)``).  ``normalize`` stretches the view's own escaped
    range over the whole colormap instead.

    ``rgba8_on`` (a torch device; not with ``normalize``) returns the
    uint8 RGBA that :func:`imsave_bytes` makes of the float RGBA,
    computed on that device through :func:`smooth_boundaries` and
    :func:`smooth_table8`: the CUDA kernel on a card, its plain version
    on the CPU.  ``nu`` may then be a tensor too, coloured where it is
    when that is the device."""
    if rgba8_on is not None:
        if normalize:
            raise ValueError("a normalised view is coloured in float RGBA")
        return _smooth_rgba8(nu, max_iter, colormap, rgba8_on)
    nu = np.asarray(nu, float)
    return _masked_colormap(_smooth_scale(nu, max_iter, normalize),
                            nu <= 0.0, colormap)


def _smooth_rows(nu: np.ndarray, max_iter: int) -> np.ndarray:
    """The table row of each escaped smooth value, as the float route
    picks it."""
    return _table_rows(_smooth_scale(nu, max_iter))


def smooth_boundaries(max_iter: int) -> np.ndarray:
    """The ``LUT_SIZE - 1`` float64 values where an escaped smooth
    value's row changes, ascending: the row of ``nu > 0`` is ``LUT_SIZE
    - 1`` less the boundaries at or below it.  The row falls as ``nu``
    grows, so boundary ``k`` is the least positive float64 whose row is
    at most ``LUT_SIZE - 1 - k``, found by bisection over the bit
    patterns (ordered as the values for ``+0.0`` up to ``inf``) with the
    float route's own arithmetic (:func:`_smooth_rows`).  Cached per
    ``max_iter`` (at least 1)."""
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    with _LOCK:
        bounds = _BOUNDARIES.get(max_iter)
    if bounds is None:
        target = LUT_SIZE - 1 - np.arange(1, LUT_SIZE)
        lo = np.zeros(LUT_SIZE - 1, np.int64)     # +0.0: taken as above
        hi = np.full(LUT_SIZE - 1, np.float64(np.inf).view(np.int64))
        while np.any(hi - lo > 1):
            mid = lo + (hi - lo) // 2
            below = _smooth_rows(mid.view(np.float64), max_iter) <= target
            hi = np.where(below, mid, hi)
            lo = np.where(below, lo, mid)
        bounds = hi.view(np.float64)
        bounds.setflags(write=False)
        with _LOCK:
            _BOUNDARIES[max_iter] = bounds
    return bounds


def smooth_table8(colormap: str) -> np.ndarray:
    """(LUT_SIZE + 4, 4) uint8 rows of a smooth view's colours:
    :func:`imsave_bytes` of :func:`colormap_table`'s rows (the end
    colours, then NaN's), then opaque black for the set.  Its last two
    rows are NaN's and the set's, as ``ops/cuda_colormap.py`` reads a
    table."""
    with _LOCK:
        table = _TABLES8.get(colormap)
    if table is None:
        rows = np.concatenate([colormap_table(colormap),
                               [(0.0, 0.0, 0.0, 1.0)]])
        table = imsave_bytes(rows[None])[0]
        table.setflags(write=False)
        with _LOCK:
            _TABLES8[colormap] = table
    return table


def _smooth_rgba8(nu, max_iter: int, colormap: str, device) -> np.ndarray:
    """``imsave_bytes(smooth_to_rgba(nu, max_iter, colormap))`` computed
    on ``device``: ``nu`` (an array, or a tensor) copied there unless it
    is there already, the bytes copied back."""
    import torch

    from distributedmandelbrot_tpu_torch.ops import cuda_colormap
    dev = torch.device(device)
    if not isinstance(nu, torch.Tensor):
        nu = torch.from_numpy(np.ascontiguousarray(nu, dtype=np.float64))
    rgba8 = cuda_colormap.colormap_rgba8(
        nu.to(dev, torch.float64).contiguous(),
        torch.tensor(smooth_boundaries(max_iter), device=dev),
        torch.tensor(smooth_table8(colormap), device=dev))
    return rgba8.cpu().numpy()


def to_rgba8(rgba: np.ndarray) -> np.ndarray:
    """Float RGBA in [0, 1] -> uint8 by rounding half up: the
    quantisation of the gateway's palette build."""
    return (np.clip(np.asarray(rgba, float), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)


def value_lut(colormap: str = "jet") -> np.ndarray:
    """(256, 4) uint8 RGBA lookup table: LUT[v] is the rendered color of
    escape value ``v`` under :func:`value_to_rgba` + :func:`to_rgba8`
    (the pipeline is pointwise, so ``LUT[tile]`` equals quantising the
    whole tile's render)."""
    with _LOCK:
        lut = _LUTS.get(colormap)
    if lut is None:
        values = np.arange(256, dtype=np.uint8)
        lut = to_rgba8(value_to_rgba(values, colormap)).reshape(256, 4)
        lut.setflags(write=False)
        with _LOCK:
            _LUTS[colormap] = lut
    return lut


def render_tile_rgba8(values: np.ndarray,
                      colormap: str = "jet") -> np.ndarray:
    """Flat or 2-D uint8 escape values -> uint8 RGBA image through the
    colormap LUT (the server's render path)."""
    return value_lut(colormap)[_as_square(values)]


def _as_square(values: np.ndarray) -> np.ndarray:
    values = np.ascontiguousarray(values, dtype=np.uint8)
    if values.ndim == 1:
        side = int(round(values.size ** 0.5))
        if side * side != values.size:
            raise ValueError(f"cannot square-reshape {values.size} pixels")
        values = values.reshape((side, side))
    return values


def imsave_bytes(rgba: np.ndarray) -> np.ndarray:
    """Float (H, W, 4) RGBA in [0, 1] -> uint8 as ``plt.imsave`` stores
    it: a pixel with any NaN channel becomes 0, then each channel is
    ``x * 255`` truncated.  Values outside [0, 1] raise, as there.
    uint8 input passes through."""
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) RGBA, got {rgba.shape}")
    if rgba.dtype == np.uint8:
        return rgba
    nans = np.isnan(rgba)
    if nans.any():
        rgba = rgba.copy()
        rgba[nans.any(axis=2), :] = 0
    if rgba.max() > 1 or rgba.min() < 0:
        raise ValueError("floating point RGBA values must be in [0, 1]")
    return (rgba * 255).astype(np.uint8)


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


# A PNG's scanlines are deflated in bands of whole rows of about this
# many bytes, each on a thread of the deflate pool.
BAND_BYTES = 1 << 18
# Deflate's window: a band is primed with the bytes this far before it.
_WINDOW = 1 << 15
_ADLER_BASE = 65521
_pool: ThreadPoolExecutor | None = None


def _deflate_pool() -> ThreadPoolExecutor:
    """The deflate threads, one a usable core, made at the first banded
    PNG."""
    global _pool
    with _LOCK:
        if _pool is None:
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            _pool = ThreadPoolExecutor(cores,
                                       thread_name_prefix="dmtpu-deflate")
        return _pool


def _deflate_band(data: memoryview, start: int, stop: int, level: int
                  ) -> tuple[bytes, int]:
    """Raw deflate of ``data[start:stop]``, primed with the window of
    bytes before it and ended on a byte boundary (a sync flush), or with
    the final block where the band ends the data; and its Adler-32."""
    primed = {"zdict": data[max(0, start - _WINDOW):start]} if start else {}
    band = data[start:stop]
    deflater = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS,
                                zlib.DEF_MEM_LEVEL, zlib.Z_DEFAULT_STRATEGY,
                                **primed)
    body = deflater.compress(band) + deflater.flush(
        zlib.Z_FINISH if stop == len(data) else zlib.Z_SYNC_FLUSH)
    return body, zlib.adler32(band)


def _adler32_combine(first: int, second: int, second_len: int) -> int:
    """The Adler-32 of two byte strings joined, from each one's and the
    second's length (zlib's ``adler32_combine``)."""
    low = ((first & 0xFFFF) + (second & 0xFFFF) - 1) % _ADLER_BASE
    high = ((first >> 16) + (second >> 16)
            + second_len * ((first & 0xFFFF) - 1)) % _ADLER_BASE
    return high << 16 | low


def _deflate_scanlines(scanlines: np.ndarray, level: int) -> bytes:
    """The zlib stream of ``scanlines`` (rows of a PNG), deflated in
    bands of whole rows at once on the pool's threads (zlib lets go of
    the GIL while it deflates); an image of one band is one
    ``zlib.compress``."""
    height, stride = scanlines.shape
    rows = max(1, BAND_BYTES // max(1, stride - 1))
    data = memoryview(scanlines).cast("B")
    bands = [(top * stride, min(top + rows, height) * stride)
             for top in range(0, height, rows)]
    phases.tally(obs_names.COUNT_RENDER_DEFLATE_BANDS, len(bands))
    if len(bands) <= 1:
        return zlib.compress(data, level)
    pool = _deflate_pool()
    parts = [f.result() for f in [
        pool.submit(_deflate_band, data, start, stop, level)
        for start, stop in bands]]
    check = parts[0][1]
    for (start, stop), (_, adler) in zip(bands[1:], parts[1:]):
        check = _adler32_combine(check, adler, stop - start)
    # The header zlib writes at this level, then the bands as one
    # deflate stream, then the Adler-32 of the whole.
    return b"".join([zlib.compress(b"", level)[:2],
                     *(body for body, _ in parts),
                     struct.pack(">I", check)])


def encode_png(rgba8: np.ndarray, *, compress_level: int = 6) -> bytes:
    """(H, W, 4) uint8 -> an 8-bit RGBA PNG (color type 6, filter 0 on
    every scanline, one IDAT, no ancillary chunks).

    The IDAT is one zlib stream at ``compress_level``, deflated in bands
    of whole rows of about :data:`BAND_BYTES` on the host's cores: each
    band is raw deflate primed with the 32 KiB before it (so its matches
    reach back across the seam as one stream's would) and ended with a
    sync flush, the last with the final block; the stream's header and
    Adler-32 are the whole input's.  The bands follow the image's shape
    alone, so the bytes are the same on any host and with any number of
    threads; an image of one band gives ``zlib.compress``'s bytes.  The
    bands deflated are added to the count ``render.deflate_bands``."""
    rgba8 = np.ascontiguousarray(rgba8, dtype=np.uint8)
    height, width, _ = rgba8.shape
    scanlines = np.zeros((height, width * 4 + 1), dtype=np.uint8)
    scanlines[:, 1:] = rgba8.reshape(height, width * 4)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT",
                         _deflate_scanlines(scanlines, compress_level))
            + _png_chunk(b"IEND", b""))


def render_tile_png(values: np.ndarray, colormap: str = "jet", *,
                    compress_level: int = 6) -> bytes:
    """Encode a tile as an 8-bit palette PNG (color type 3, filter 0):
    the index plane is the escape-value tile, the PLTE the RGB of
    :func:`value_lut` (alpha is 255 everywhere, so no tRNS).  Fixed
    filter, fixed zlib level, no ancillary chunks: the JAX package's
    bytes."""
    square = _as_square(values)
    height, width = square.shape
    lut = value_lut(colormap)
    scanlines = np.zeros((height, width + 1), dtype=np.uint8)
    scanlines[:, 1:] = square
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 3, 0, 0, 0)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"PLTE", lut[:, :3].tobytes())
            + _png_chunk(b"IDAT", zlib.compress(scanlines.tobytes(),
                                                compress_level))
            + _png_chunk(b"IEND", b""))


def decode_rendered_png(data: bytes) -> np.ndarray:
    """Decode a :func:`render_tile_png` body back to uint8 RGBA.  Only
    palette PNGs with filter 0, as :func:`render_tile_png` writes them;
    anything else raises ``ValueError``, and so does an IDAT that
    inflates past the size IHDR states."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos = len(PNG_SIGNATURE)
    ihdr = None
    palette = None
    idat = bytearray()
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length + tag + body + crc
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if ihdr is None or palette is None or not idat:
        raise ValueError("missing IHDR/PLTE/IDAT chunk")
    width, height, depth, color_type, _, _, interlace = ihdr
    if (depth, color_type, interlace) != (8, 3, 0):
        raise ValueError(
            f"unsupported PNG shape: depth={depth} color={color_type} "
            f"interlace={interlace}")
    expected = height * (width + 1)
    inflater = zlib.decompressobj()
    decoded = inflater.decompress(bytes(idat), expected)
    if not inflater.eof or inflater.unconsumed_tail \
            or inflater.decompress(b"", 1):
        raise ValueError(
            f"IDAT decodes past the {expected} bytes IHDR promises")
    raw = np.frombuffer(decoded, np.uint8)
    if raw.size != expected:
        raise ValueError(f"IDAT decodes to {raw.size} bytes, expected "
                         f"{expected}")
    scanlines = raw.reshape(height, width + 1)
    if np.any(scanlines[:, 0] != 0):
        raise ValueError("unsupported PNG filter (encoder emits 0 only)")
    indices = scanlines[:, 1:]
    rgba = np.empty((height, width, 4), dtype=np.uint8)
    rgba[..., :3] = palette[indices]
    rgba[..., 3] = 255
    return rgba
