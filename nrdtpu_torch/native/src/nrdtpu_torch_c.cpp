/*
 * nrdtpu C ABI of the PyTorch port - the native host runtime around nrdtpu_torch.engine.
 *
 * A port of native/src/nrdtpu_c.cpp onto the port's Engine: the shim owns the embedded Python
 * interpreter, the engine objects, the settings marshalling and the plane staging, and calls
 * nrdtpu_torch.engine for the compute, on the card unless the instance was created on "cpu".
 * Input planes go to the Engine as numpy arrays; outputs come back through
 * `.detach().cpu().numpy()`. Loaded into a running Python process (ctypes) it attaches to that
 * interpreter. Loaded by a C program it starts one (`Py_InitializeFromConfig`) as the Python
 * that built it (NRDTPU_PYTHON, set by nrdtpu_torch/native/build.py, so that its packages,
 * torch among them, are found), then puts the directory above `nrdtpu_torch/` on sys.path,
 * found from this library's own path (dladdr). Every call takes the GIL.
 */

#include "nrdtpu_c.h"

#include <Python.h>
#include <dlfcn.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#ifndef NRDTPU_PYTHON
#define NRDTPU_PYTHON ""
#endif

namespace {

thread_local std::string g_last_error;
std::once_flag g_py_init_flag;
bool g_py_init_failed = false;

void set_error(const std::string& msg) { g_last_error = msg; }

void fetch_python_error() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    std::string msg = "python error";
    if (type) {  /* "ExceptionType: message" */
        PyObject* name = PyObject_GetAttrString(type, "__name__");
        const char* u = name ? PyUnicode_AsUTF8(name) : nullptr;
        if (u) msg = u;
        Py_XDECREF(name);
    }
    if (value) {
        PyObject* s = PyObject_Str(value);
        const char* u = s ? PyUnicode_AsUTF8(s) : nullptr;
        if (u && *u) msg += std::string(": ") + u;
        Py_XDECREF(s);
    }
    PyErr_Clear();
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    set_error(msg);
}

/* The directory that holds the nrdtpu_torch package: this library lives in
 * <root>/nrdtpu_torch/native/_build/. */
std::string package_root() {
    Dl_info info;
    if (!dladdr(reinterpret_cast<void*>(&package_root), &info) || !info.dli_fname) return "";
    std::string p(info.dli_fname);
    for (int i = 0; i < 4; i++) {
        size_t slash = p.find_last_of('/');
        if (slash == std::string::npos) return "";
        p.resize(slash);
    }
    return p;
}

/* RAII GIL acquisition - the shim must be callable from any thread. */
class GilGuard {
  public:
    GilGuard() : state_(PyGILState_Ensure()) {}
    ~GilGuard() { PyGILState_Release(state_); }

  private:
    PyGILState_STATE state_;
};

/* Start the interpreter once, if no Python runs this process yet, and release the GIL so that
 * GilGuard works from any thread; then put the package root on sys.path. */
bool ensure_python() {
    std::call_once(g_py_init_flag, [] {
        if (!Py_IsInitialized()) {
            PyConfig config;
            PyConfig_InitPythonConfig(&config);
            config.install_signal_handlers = 0;
            PyStatus st = PyStatus_Ok();
            if (NRDTPU_PYTHON[0])
                st = PyConfig_SetBytesString(&config, &config.program_name, NRDTPU_PYTHON);
            if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
            PyConfig_Clear(&config);
            if (PyStatus_Exception(st)) {
                g_py_init_failed = true;
                return;
            }
            PyEval_SaveThread();
        }
        GilGuard gil;
        std::string root = package_root();
        PyObject* path = PySys_GetObject("path"); /* borrowed */
        PyObject* entry = PyUnicode_FromString(root.c_str());
        if (path && entry && !root.empty() && PySequence_Contains(path, entry) == 0)
            PyList_Insert(path, 0, entry);
        Py_XDECREF(entry);
    });
    if (g_py_init_failed) set_error("the embedded Python interpreter failed to start");
    return !g_py_init_failed;
}

struct Ref {
    PyObject* p = nullptr;
    Ref() = default;
    explicit Ref(PyObject* o) : p(o) {}
    ~Ref() { Py_XDECREF(p); }
    Ref(const Ref&) = delete;
    Ref& operator=(const Ref&) = delete;
    Ref(Ref&& other) noexcept : p(other.p) { other.p = nullptr; }
    Ref& operator=(Ref&& other) noexcept {
        if (this != &other) {
            Py_XDECREF(p);
            p = other.p;
            other.p = nullptr;
        }
        return *this;
    }
    PyObject* release() {
        PyObject* o = p;
        p = nullptr;
        return o;
    }
    explicit operator bool() const { return p != nullptr; }
};

}  // namespace

struct nrdtpu_instance {
    PyObject* engine = nullptr;       /* nrdtpu_torch.engine.Engine */
    PyObject* np_module = nullptr;    /* numpy */
    uint16_t width = 0, height = 0;   /* the resource size: every plane's */
};

extern "C" {

const char* nrdtpu_get_version_string(void) { return "nrdtpu_torch 0.1.0"; }

const char* nrdtpu_get_last_error(void) { return g_last_error.c_str(); }

nrdtpu_result nrdtpu_create_instance_device(const nrdtpu_denoiser_desc* denoisers,
                                            uint32_t denoiser_num,
                                            uint16_t resource_w, uint16_t resource_h,
                                            uint32_t normal_encoding,
                                            uint32_t roughness_encoding,
                                            const char* device,
                                            nrdtpu_instance** out_instance) {
    if (!denoisers || denoiser_num == 0 || !out_instance || !resource_w || !resource_h ||
        !device) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    if (!ensure_python()) return NRDTPU_FAILURE;
    GilGuard gil;

    Ref engine_mod(PyImport_ImportModule("nrdtpu_torch.engine"));
    if (!engine_mod) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    Ref settings_mod(PyImport_ImportModule("nrdtpu_torch.settings"));
    Ref np_mod(PyImport_ImportModule("numpy"));
    if (!settings_mod || !np_mod) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }

    Ref denoiser_enum(PyObject_GetAttrString(settings_mod.p, "Denoiser"));
    Ref ne_enum(PyObject_GetAttrString(settings_mod.p, "NormalEncoding"));
    Ref re_enum(PyObject_GetAttrString(settings_mod.p, "RoughnessEncoding"));
    Ref denoiser_map(PyDict_New());
    for (uint32_t i = 0; i < denoiser_num; i++) {
        Ref key(PyLong_FromUnsignedLong(denoisers[i].identifier));
        Ref dval(PyObject_CallFunction(denoiser_enum.p, "i", (int)denoisers[i].denoiser));
        if (!dval) {
            fetch_python_error();
            return NRDTPU_INVALID_ARGUMENT;
        }
        PyDict_SetItem(denoiser_map.p, key.p, dval.p);
    }
    Ref size(Py_BuildValue("(ii)", (int)resource_w, (int)resource_h));
    Ref ne(PyObject_CallFunction(ne_enum.p, "i", (int)normal_encoding));
    Ref re(PyObject_CallFunction(re_enum.p, "i", (int)roughness_encoding));
    Ref engine_cls(PyObject_GetAttrString(engine_mod.p, "Engine"));
    Ref dev(PyUnicode_FromString(device));
    if (!engine_cls || !ne || !re || !dev) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    Ref kwargs(PyDict_New());
    PyDict_SetItemString(kwargs.p, "normal_encoding", ne.p);
    PyDict_SetItemString(kwargs.p, "roughness_encoding", re.p);
    PyDict_SetItemString(kwargs.p, "device", dev.p);
    Ref args(Py_BuildValue("(OO)", denoiser_map.p, size.p));
    Ref engine(PyObject_Call(engine_cls.p, args.p, kwargs.p));
    if (!engine) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }

    auto* inst = new nrdtpu_instance();
    inst->engine = engine.release();
    inst->np_module = np_mod.release();
    inst->width = resource_w;
    inst->height = resource_h;
    *out_instance = inst;
    return NRDTPU_SUCCESS;
}

nrdtpu_result nrdtpu_create_instance(const nrdtpu_denoiser_desc* denoisers,
                                     uint32_t denoiser_num,
                                     uint16_t resource_w, uint16_t resource_h,
                                     uint32_t normal_encoding,
                                     uint32_t roughness_encoding,
                                     nrdtpu_instance** out_instance) {
    return nrdtpu_create_instance_device(denoisers, denoiser_num, resource_w, resource_h,
                                         normal_encoding, roughness_encoding, "cuda",
                                         out_instance);
}

nrdtpu_result nrdtpu_set_common_settings(nrdtpu_instance* inst,
                                         const nrdtpu_common_settings* s) {
    if (!inst || !s) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    GilGuard gil;
    Ref settings_mod(PyImport_ImportModule("nrdtpu_torch.settings"));
    Ref cs_cls(settings_mod ? PyObject_GetAttrString(settings_mod.p, "CommonSettings") : nullptr);
    Ref cs(cs_cls ? PyObject_CallNoArgs(cs_cls.p) : nullptr);
    if (!cs) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }

    auto set_floats = [&](const char* name, const float* v, int n) {
        Ref lst(PyList_New(n));
        for (int i = 0; i < n; i++) PyList_SetItem(lst.p, i, PyFloat_FromDouble(v[i]));
        PyObject_SetAttrString(cs.p, name, lst.p);
    };
    auto set_ints2 = [&](const char* name, int a, int b) {
        Ref t(Py_BuildValue("(ii)", a, b));
        PyObject_SetAttrString(cs.p, name, t.p);
    };
    auto set_f = [&](const char* name, double v) {
        Ref f(PyFloat_FromDouble(v));
        PyObject_SetAttrString(cs.p, name, f.p);
    };
    auto set_i = [&](const char* name, long v) {
        Ref f(PyLong_FromLong(v));
        PyObject_SetAttrString(cs.p, name, f.p);
    };
    auto set_b = [&](const char* name, bool v) {
        PyObject_SetAttrString(cs.p, name, v ? Py_True : Py_False);
    };

    set_floats("viewToClipMatrix", s->view_to_clip_matrix, 16);
    set_floats("viewToClipMatrixPrev", s->view_to_clip_matrix_prev, 16);
    set_floats("worldToViewMatrix", s->world_to_view_matrix, 16);
    set_floats("worldToViewMatrixPrev", s->world_to_view_matrix_prev, 16);
    set_floats("worldPrevToWorldMatrix", s->world_prev_to_world_matrix, 16);
    {
        Ref t(Py_BuildValue("(fff)", s->motion_vector_scale[0], s->motion_vector_scale[1],
                            s->motion_vector_scale[2]));
        PyObject_SetAttrString(cs.p, "motionVectorScale", t.p);
    }
    {
        Ref t(Py_BuildValue("(ff)", s->camera_jitter[0], s->camera_jitter[1]));
        PyObject_SetAttrString(cs.p, "cameraJitter", t.p);
        Ref t2(Py_BuildValue("(ff)", s->camera_jitter_prev[0], s->camera_jitter_prev[1]));
        PyObject_SetAttrString(cs.p, "cameraJitterPrev", t2.p);
    }
    set_ints2("resourceSize", s->resource_size[0], s->resource_size[1]);
    set_ints2("resourceSizePrev", s->resource_size_prev[0], s->resource_size_prev[1]);
    set_ints2("rectSize", s->rect_size[0], s->rect_size[1]);
    set_ints2("rectSizePrev", s->rect_size_prev[0], s->rect_size_prev[1]);
    set_f("viewZScale", s->view_z_scale);
    set_f("timeDeltaBetweenFrames", s->time_delta_between_frames);
    set_f("denoisingRange", s->denoising_range);
    set_f("disocclusionThreshold", s->disocclusion_threshold);
    set_f("disocclusionThresholdAlternate", s->disocclusion_threshold_alternate);
    set_f("cameraAttachedReflectionMaterialID", s->camera_attached_reflection_material_id);
    set_f("strandMaterialID", s->strand_material_id);
    set_f("strandThickness", s->strand_thickness);
    set_f("splitScreen", s->split_screen);
    set_f("debug", s->debug);
    set_ints2("rectOrigin", (int)s->rect_origin[0], (int)s->rect_origin[1]);
    set_i("frameIndex", (long)s->frame_index);
    {
        Ref am_cls(PyObject_GetAttrString(settings_mod.p, "AccumulationMode"));
        Ref am(PyObject_CallFunction(am_cls.p, "i", (int)s->accumulation_mode));
        PyObject_SetAttrString(cs.p, "accumulationMode", am.p);
    }
    set_b("isMotionVectorInWorldSpace", s->is_motion_vector_in_world_space);
    set_b("isHistoryConfidenceAvailable", s->is_history_confidence_available);
    set_b("isDisocclusionThresholdMixAvailable",
          s->is_disocclusion_threshold_mix_available);
    set_b("isBaseColorMetalnessAvailable", s->is_base_color_metalness_available);
    set_b("enableValidation", s->enable_validation);

    Ref result(PyObject_CallMethod(inst->engine, "set_common_settings", "O", cs.p));
    if (!result) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    return NRDTPU_SUCCESS;
}

nrdtpu_result nrdtpu_set_denoiser_settings(nrdtpu_instance* inst, uint32_t identifier,
                                           const char* settings_kv) {
    if (!inst || !settings_kv) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    GilGuard gil;
    /* current settings object for the identifier */
    Ref settings(PyObject_GetAttrString(inst->engine, "_settings"));
    Ref key(PyLong_FromUnsignedLong(identifier));
    PyObject* cur = PyDict_GetItem(settings.p, key.p); /* borrowed */
    if (!cur) {
        set_error("unknown identifier");
        return NRDTPU_INVALID_ARGUMENT;
    }
    /* parse "a=1;b=2.5;c.d=3" assignments onto the dataclass */
    std::string kv(settings_kv);
    size_t pos = 0;
    while (pos < kv.size()) {
        size_t end = kv.find(';', pos);
        if (end == std::string::npos) end = kv.size();
        std::string pair = kv.substr(pos, end - pos);
        pos = end + 1;
        size_t eq = pair.find('=');
        if (eq == std::string::npos) continue;
        std::string name = pair.substr(0, eq);
        std::string value = pair.substr(eq + 1);
        PyObject* target = cur;
        Ref nested;
        size_t dot;
        while ((dot = name.find('.')) != std::string::npos) {
            nested = Ref(PyObject_GetAttrString(target, name.substr(0, dot).c_str()));
            if (!nested) {
                fetch_python_error();
                return NRDTPU_INVALID_ARGUMENT;
            }
            target = nested.p;
            name = name.substr(dot + 1);
        }
        Ref old(PyObject_GetAttrString(target, name.c_str()));
        if (!old) {
            fetch_python_error();
            return NRDTPU_INVALID_ARGUMENT;
        }
        Ref newval;
        if (PyBool_Check(old.p)) {
            newval = Ref(PyBool_FromLong(value == "1" || value == "true"));
        } else if (PyLong_Check(old.p)) {
            newval = Ref(PyLong_FromLong(std::strtol(value.c_str(), nullptr, 10)));
        } else if (PyFloat_Check(old.p)) {
            newval = Ref(PyFloat_FromDouble(std::strtod(value.c_str(), nullptr)));
        } else {
            /* enum-like: construct type(old)(int(value)) */
            Ref ty(PyObject_Type(old.p));
            newval = Ref(PyObject_CallFunction(
                ty.p, "i", (int)std::strtol(value.c_str(), nullptr, 10)));
        }
        if (!newval || PyObject_SetAttrString(target, name.c_str(), newval.p) != 0) {
            fetch_python_error();
            return NRDTPU_INVALID_ARGUMENT;
        }
    }
    Ref res(PyObject_CallMethod(inst->engine, "set_denoiser_settings", "IO",
                                identifier, cur));
    if (!res) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    return NRDTPU_SUCCESS;
}

nrdtpu_result nrdtpu_denoise(nrdtpu_instance* inst, const uint32_t* identifiers,
                             uint32_t identifier_num, const nrdtpu_resource_slot* slots,
                             uint32_t slot_num) {
    if (!inst || !identifiers || !identifier_num || !slots) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    GilGuard gil;

    Ref settings_mod(PyImport_ImportModule("nrdtpu_torch.settings"));
    if (!settings_mod) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    Ref rt_enum(PyObject_GetAttrString(settings_mod.p, "ResourceType"));
    Ref np_frombuffer(PyObject_GetAttrString(inst->np_module, "frombuffer"));

    const Py_ssize_t h = inst->height, w = inst->width;
    Ref pool(PyDict_New());
    for (uint32_t i = 0; i < slot_num; i++) {
        const nrdtpu_resource_slot& slot = slots[i];
        if (slot.type >= NRDTPU_OUT_DIFF_RADIANCE_HITDIST) continue; /* outputs below */
        const Py_ssize_t n = h * w * (Py_ssize_t)slot.channels;
        Ref mem(PyMemoryView_FromMemory(reinterpret_cast<char*>(slot.data),
                                        n * (Py_ssize_t)sizeof(float), PyBUF_READ));
        Ref flat(PyObject_CallFunction(np_frombuffer.p, "Os", mem.p, "float32"));
        if (!flat) {
            fetch_python_error();
            return NRDTPU_FAILURE;
        }
        Ref shape(slot.channels == 1 ? Py_BuildValue("(nn)", h, w)
                                     : Py_BuildValue("(nnn)", h, w, (Py_ssize_t)slot.channels));
        Ref shaped(PyObject_CallMethod(flat.p, "reshape", "O", shape.p));
        Ref key(PyObject_CallFunction(rt_enum.p, "i", (int)slot.type));
        if (!shaped || !key) {
            fetch_python_error();
            return NRDTPU_FAILURE;
        }
        PyDict_SetItem(pool.p, key.p, shaped.p);
    }

    Ref idents(PyList_New(identifier_num));
    for (uint32_t i = 0; i < identifier_num; i++)
        PyList_SetItem(idents.p, i, PyLong_FromUnsignedLong(identifiers[i]));

    Ref outs(PyObject_CallMethod(inst->engine, "denoise", "OO", idents.p, pool.p));
    if (!outs) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }

    /* copy outputs back into the caller's planes: the tensor to the host, then its bytes */
    Ref np_ascontiguousarray(PyObject_GetAttrString(inst->np_module, "ascontiguousarray"));
    for (uint32_t i = 0; i < slot_num; i++) {
        const nrdtpu_resource_slot& slot = slots[i];
        if (slot.type < NRDTPU_OUT_DIFF_RADIANCE_HITDIST) continue;
        Ref key(PyObject_CallFunction(rt_enum.p, "i", (int)slot.type));
        PyObject* value = key ? PyDict_GetItem(outs.p, key.p) : nullptr; /* borrowed */
        if (!value) continue;                                            /* not produced */
        Ref detached(PyObject_CallMethod(value, "detach", nullptr));
        Ref host(detached ? PyObject_CallMethod(detached.p, "cpu", nullptr) : nullptr);
        Ref arr(host ? PyObject_CallMethod(host.p, "numpy", nullptr) : nullptr);
        Ref contig(arr ? PyObject_CallFunction(np_ascontiguousarray.p, "Os", arr.p, "float32")
                       : nullptr);
        Ref bytes(contig ? PyObject_CallMethod(contig.p, "tobytes", nullptr) : nullptr);
        if (!bytes) {
            fetch_python_error();
            return NRDTPU_FAILURE;
        }
        char* buf = nullptr;
        Py_ssize_t len = 0;
        PyBytes_AsStringAndSize(bytes.p, &buf, &len);
        const Py_ssize_t expect = h * w * (Py_ssize_t)slot.channels
                                  * (Py_ssize_t)sizeof(float);
        if (len != expect) {
            set_error("output size mismatch for resource " + std::to_string(slot.type));
            return NRDTPU_FAILURE;
        }
        std::memcpy(slot.data, buf, (size_t)len);
    }
    return NRDTPU_SUCCESS;
}

nrdtpu_result nrdtpu_destroy_instance(nrdtpu_instance* inst) {
    if (!inst) return NRDTPU_INVALID_ARGUMENT;
    {
        GilGuard gil;
        Py_XDECREF(inst->engine);
        Py_XDECREF(inst->np_module);
    }
    delete inst;
    return NRDTPU_SUCCESS;
}

/* -------------------------------------------------------------------------
 * Library desc + name tables (Wrapper.cpp:46-123 analogue)
 * ------------------------------------------------------------------------- */

static const nrdtpu_denoiser g_supported_denoisers[] = {
    NRDTPU_REBLUR_DIFFUSE,
    NRDTPU_REBLUR_DIFFUSE_OCCLUSION,
    NRDTPU_REBLUR_DIFFUSE_SH,
    NRDTPU_REBLUR_SPECULAR,
    NRDTPU_REBLUR_SPECULAR_OCCLUSION,
    NRDTPU_REBLUR_SPECULAR_SH,
    NRDTPU_REBLUR_DIFFUSE_SPECULAR,
    NRDTPU_REBLUR_DIFFUSE_SPECULAR_OCCLUSION,
    NRDTPU_REBLUR_DIFFUSE_SPECULAR_SH,
    NRDTPU_REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION,
    NRDTPU_RELAX_DIFFUSE,
    NRDTPU_RELAX_DIFFUSE_SH,
    NRDTPU_RELAX_SPECULAR,
    NRDTPU_RELAX_SPECULAR_SH,
    NRDTPU_RELAX_DIFFUSE_SPECULAR,
    NRDTPU_RELAX_DIFFUSE_SPECULAR_SH,
    NRDTPU_SIGMA_SHADOW,
    NRDTPU_SIGMA_SHADOW_TRANSLUCENCY,
    NRDTPU_REFERENCE,
};

static const nrdtpu_library_desc g_library_desc = {
    NRDTPU_VERSION_MAJOR,
    NRDTPU_VERSION_MINOR,
    g_supported_denoisers,
    (uint32_t)(sizeof(g_supported_denoisers) / sizeof(g_supported_denoisers[0])),
    2, /* NormalEncoding::R10_G10_B10_A2_UNORM - the engine's default */
    0, /* RoughnessEncoding::LINEAR */
};

static const char* g_denoiser_names[] = {
    "REBLUR_DIFFUSE",
    "REBLUR_DIFFUSE_OCCLUSION",
    "REBLUR_DIFFUSE_SH",
    "REBLUR_SPECULAR",
    "REBLUR_SPECULAR_OCCLUSION",
    "REBLUR_SPECULAR_SH",
    "REBLUR_DIFFUSE_SPECULAR",
    "REBLUR_DIFFUSE_SPECULAR_OCCLUSION",
    "REBLUR_DIFFUSE_SPECULAR_SH",
    "REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION",
    "RELAX_DIFFUSE",
    "RELAX_DIFFUSE_SH",
    "RELAX_SPECULAR",
    "RELAX_SPECULAR_SH",
    "RELAX_DIFFUSE_SPECULAR",
    "RELAX_DIFFUSE_SPECULAR_SH",
    "SIGMA_SHADOW",
    "SIGMA_SHADOW_TRANSLUCENCY",
    "REFERENCE",
};

static const char* g_resource_names[] = {
    "IN_MV",
    "IN_NORMAL_ROUGHNESS",
    "IN_VIEWZ",
    "IN_DIFF_CONFIDENCE",
    "IN_SPEC_CONFIDENCE",
    "IN_DISOCCLUSION_THRESHOLD_MIX",
    "IN_BASECOLOR_METALNESS",
    "IN_DIFF_RADIANCE_HITDIST",
    "IN_SPEC_RADIANCE_HITDIST",
    "IN_DIFF_HITDIST",
    "IN_SPEC_HITDIST",
    "IN_DIFF_DIRECTION_HITDIST",
    "IN_DIFF_SH0",
    "IN_DIFF_SH1",
    "IN_SPEC_SH0",
    "IN_SPEC_SH1",
    "IN_PENUMBRA",
    "IN_TRANSLUCENCY",
    "IN_SIGNAL",
    "OUT_DIFF_RADIANCE_HITDIST",
    "OUT_SPEC_RADIANCE_HITDIST",
    "OUT_DIFF_SH0",
    "OUT_DIFF_SH1",
    "OUT_SPEC_SH0",
    "OUT_SPEC_SH1",
    "OUT_DIFF_HITDIST",
    "OUT_SPEC_HITDIST",
    "OUT_DIFF_DIRECTION_HITDIST",
    "OUT_SHADOW_TRANSLUCENCY",
    "OUT_SIGNAL",
    "OUT_VALIDATION",
};

static_assert(sizeof(g_denoiser_names) / sizeof(g_denoiser_names[0]) ==
                  (size_t)NRDTPU_REFERENCE + 1,
              "denoiser name table out of sync");
static_assert(sizeof(g_resource_names) / sizeof(g_resource_names[0]) ==
                  (size_t)NRDTPU_RESOURCE_MAX_NUM,
              "resource name table out of sync");

const nrdtpu_library_desc* nrdtpu_get_library_desc(void) { return &g_library_desc; }

const char* nrdtpu_get_denoiser_string(nrdtpu_denoiser d) {
    if ((uint32_t)d > (uint32_t)NRDTPU_REFERENCE) return "";
    return g_denoiser_names[(uint32_t)d];
}

const char* nrdtpu_get_resource_type_string(nrdtpu_resource r) {
    if ((uint32_t)r >= (uint32_t)NRDTPU_RESOURCE_MAX_NUM) return "";
    return g_resource_names[(uint32_t)r];
}

/* -------------------------------------------------------------------------
 * Typed settings marshalling. Each typed setter serializes to the text kv
 * protocol so the python dataclass stays the single source of field truth.
 * kvf = float field, kvu = integer/enum/bool field.
 * ------------------------------------------------------------------------- */

static void kvf(std::string& out, const char* name, double v) {
    char buf[96];
    snprintf(buf, sizeof(buf), "%s=%.9g;", name, v);
    out += buf;
}

static void kvu(std::string& out, const char* name, uint32_t v) {
    char buf[96];
    snprintf(buf, sizeof(buf), "%s=%u;", name, v);
    out += buf;
}

void nrdtpu_get_default_reblur_settings(nrdtpu_reblur_settings* s) {
    if (!s) return;
    *s = nrdtpu_reblur_settings{};
    s->hit_distance_parameters = {3.0f, 0.1f, 20.0f, -25.0f};
    s->antilag_luminance_sigma_scale = 4.0f;
    s->antilag_luminance_sensitivity = 3.0f;
    s->max_accumulated_frame_num = 30;
    s->max_fast_accumulated_frame_num = 6;
    s->max_stabilized_frame_num = 63; /* REBLUR_MAX_HISTORY_FRAME_NUM */
    s->max_stabilized_frame_num_for_hit_distance = 63;
    s->history_fix_frame_num = 3;
    s->history_fix_base_pixel_stride = 14;
    s->diffuse_prepass_blur_radius = 30.0f;
    s->specular_prepass_blur_radius = 50.0f;
    s->min_hit_distance_weight = 0.1f;
    s->min_blur_radius = 1.0f;
    s->max_blur_radius = 30.0f;
    s->lobe_angle_fraction = 0.15f;
    s->roughness_fraction = 0.15f;
    s->responsive_accumulation_roughness_threshold = 0.0f;
    s->plane_distance_sensitivity = 0.02f;
    s->specular_probability_thresholds_for_mv_modification[0] = 0.5f;
    s->specular_probability_thresholds_for_mv_modification[1] = 0.9f;
    s->firefly_suppressor_min_relative_scale = 2.0f;
    s->min_material_for_diffuse = 4.0f;
    s->min_material_for_specular = 4.0f;
}

void nrdtpu_get_default_relax_settings(nrdtpu_relax_settings* s) {
    if (!s) return;
    *s = nrdtpu_relax_settings{};
    s->antilag_acceleration_amount = 0.3f;
    s->antilag_spatial_sigma_scale = 4.5f;
    s->antilag_temporal_sigma_scale = 0.5f;
    s->antilag_reset_amount = 0.5f;
    s->diffuse_max_accumulated_frame_num = 30;
    s->specular_max_accumulated_frame_num = 30;
    s->diffuse_max_fast_accumulated_frame_num = 6;
    s->specular_max_fast_accumulated_frame_num = 6;
    s->history_fix_frame_num = 3;
    s->history_fix_base_pixel_stride = 14;
    s->history_fix_edge_stopping_normal_power = 8.0f;
    s->spatial_variance_estimation_history_threshold = 3;
    s->diffuse_prepass_blur_radius = 30.0f;
    s->specular_prepass_blur_radius = 50.0f;
    s->min_hit_distance_weight = 0.1f;
    s->diffuse_phi_luminance = 2.0f;
    s->specular_phi_luminance = 1.0f;
    s->lobe_angle_fraction = 0.5f;
    s->roughness_fraction = 0.15f;
    s->specular_variance_boost = 0.0f;
    s->specular_lobe_angle_slack = 0.15f;
    s->history_clamping_color_box_sigma_scale = 2.0f;
    s->atrous_iteration_num = 5;
    s->depth_threshold = 0.003f;
    s->luminance_edge_stopping_relaxation = 0.5f;
    s->normal_edge_stopping_relaxation = 0.3f;
    s->roughness_edge_stopping_relaxation = 1.0f;
    s->enable_roughness_edge_stopping = 1;
    s->min_material_for_diffuse = 4.0f;
    s->min_material_for_specular = 4.0f;
}

void nrdtpu_get_default_sigma_settings(nrdtpu_sigma_settings* s) {
    if (!s) return;
    *s = nrdtpu_sigma_settings{};
    s->plane_distance_sensitivity = 0.02f;
    s->max_stabilized_frame_num = 5;
}

void nrdtpu_get_default_reference_settings(nrdtpu_reference_settings* s) {
    if (!s) return;
    s->max_accumulated_frame_num = 1020;
}

nrdtpu_result nrdtpu_set_reblur_settings(nrdtpu_instance* inst, uint32_t identifier,
                                         const nrdtpu_reblur_settings* s) {
    if (!s) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    std::string t;
    kvf(t, "hitDistanceParameters.A", s->hit_distance_parameters.a);
    kvf(t, "hitDistanceParameters.B", s->hit_distance_parameters.b);
    kvf(t, "hitDistanceParameters.C", s->hit_distance_parameters.c);
    kvf(t, "hitDistanceParameters.D", s->hit_distance_parameters.d);
    kvf(t, "antilagSettings.luminanceSigmaScale", s->antilag_luminance_sigma_scale);
    kvf(t, "antilagSettings.luminanceSensitivity", s->antilag_luminance_sensitivity);
    kvu(t, "maxAccumulatedFrameNum", s->max_accumulated_frame_num);
    kvu(t, "maxFastAccumulatedFrameNum", s->max_fast_accumulated_frame_num);
    kvu(t, "maxStabilizedFrameNum", s->max_stabilized_frame_num);
    kvu(t, "maxStabilizedFrameNumForHitDistance",
        s->max_stabilized_frame_num_for_hit_distance);
    kvu(t, "historyFixFrameNum", s->history_fix_frame_num);
    kvu(t, "historyFixBasePixelStride", s->history_fix_base_pixel_stride);
    kvf(t, "diffusePrepassBlurRadius", s->diffuse_prepass_blur_radius);
    kvf(t, "specularPrepassBlurRadius", s->specular_prepass_blur_radius);
    kvf(t, "minHitDistanceWeight", s->min_hit_distance_weight);
    kvf(t, "minBlurRadius", s->min_blur_radius);
    kvf(t, "maxBlurRadius", s->max_blur_radius);
    kvf(t, "lobeAngleFraction", s->lobe_angle_fraction);
    kvf(t, "roughnessFraction", s->roughness_fraction);
    kvf(t, "responsiveAccumulationRoughnessThreshold",
        s->responsive_accumulation_roughness_threshold);
    kvf(t, "planeDistanceSensitivity", s->plane_distance_sensitivity);
    kvf(t, "fireflySuppressorMinRelativeScale",
        s->firefly_suppressor_min_relative_scale);
    kvu(t, "checkerboardMode", s->checkerboard_mode);
    kvu(t, "hitDistanceReconstructionMode", s->hit_distance_reconstruction_mode);
    kvu(t, "enableAntiFirefly", (uint32_t)s->enable_anti_firefly);
    kvu(t, "enablePerformanceMode", (uint32_t)s->enable_performance_mode);
    kvf(t, "minMaterialForDiffuse", s->min_material_for_diffuse);
    kvf(t, "minMaterialForSpecular", s->min_material_for_specular);
    kvu(t, "usePrepassOnlyForSpecularMotionEstimation",
        (uint32_t)s->use_prepass_only_for_specular_motion_estimation);
    nrdtpu_result r = nrdtpu_set_denoiser_settings(inst, identifier, t.c_str());
    if (r != NRDTPU_SUCCESS) return r;
    /* tuple field: set as a python tuple (the kv parser handles scalars only) */
    GilGuard gil;
    Ref settings(PyObject_GetAttrString(inst->engine, "_settings"));
    Ref key(PyLong_FromUnsignedLong(identifier));
    PyObject* cur = PyDict_GetItem(settings.p, key.p); /* borrowed */
    Ref tup(Py_BuildValue("(ff)",
                          s->specular_probability_thresholds_for_mv_modification[0],
                          s->specular_probability_thresholds_for_mv_modification[1]));
    if (!cur || !tup ||
        PyObject_SetAttrString(cur, "specularProbabilityThresholdsForMvModification",
                               tup.p) != 0) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    return NRDTPU_SUCCESS;
}

nrdtpu_result nrdtpu_set_relax_settings(nrdtpu_instance* inst, uint32_t identifier,
                                        const nrdtpu_relax_settings* s) {
    if (!s) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    std::string t;
    kvf(t, "antilagSettings.accelerationAmount", s->antilag_acceleration_amount);
    kvf(t, "antilagSettings.spatialSigmaScale", s->antilag_spatial_sigma_scale);
    kvf(t, "antilagSettings.temporalSigmaScale", s->antilag_temporal_sigma_scale);
    kvf(t, "antilagSettings.resetAmount", s->antilag_reset_amount);
    kvu(t, "diffuseMaxAccumulatedFrameNum", s->diffuse_max_accumulated_frame_num);
    kvu(t, "specularMaxAccumulatedFrameNum", s->specular_max_accumulated_frame_num);
    kvu(t, "diffuseMaxFastAccumulatedFrameNum",
        s->diffuse_max_fast_accumulated_frame_num);
    kvu(t, "specularMaxFastAccumulatedFrameNum",
        s->specular_max_fast_accumulated_frame_num);
    kvu(t, "historyFixFrameNum", s->history_fix_frame_num);
    kvu(t, "historyFixBasePixelStride", s->history_fix_base_pixel_stride);
    kvf(t, "historyFixEdgeStoppingNormalPower",
        s->history_fix_edge_stopping_normal_power);
    kvu(t, "spatialVarianceEstimationHistoryThreshold",
        s->spatial_variance_estimation_history_threshold);
    kvf(t, "diffusePrepassBlurRadius", s->diffuse_prepass_blur_radius);
    kvf(t, "specularPrepassBlurRadius", s->specular_prepass_blur_radius);
    kvf(t, "minHitDistanceWeight", s->min_hit_distance_weight);
    kvf(t, "diffusePhiLuminance", s->diffuse_phi_luminance);
    kvf(t, "specularPhiLuminance", s->specular_phi_luminance);
    kvf(t, "lobeAngleFraction", s->lobe_angle_fraction);
    kvf(t, "roughnessFraction", s->roughness_fraction);
    kvf(t, "specularVarianceBoost", s->specular_variance_boost);
    kvf(t, "specularLobeAngleSlack", s->specular_lobe_angle_slack);
    kvf(t, "historyClampingColorBoxSigmaScale",
        s->history_clamping_color_box_sigma_scale);
    kvu(t, "atrousIterationNum", s->atrous_iteration_num);
    kvf(t, "diffuseMinLuminanceWeight", s->diffuse_min_luminance_weight);
    kvf(t, "specularMinLuminanceWeight", s->specular_min_luminance_weight);
    kvf(t, "depthThreshold", s->depth_threshold);
    kvf(t, "confidenceDrivenRelaxationMultiplier",
        s->confidence_driven_relaxation_multiplier);
    kvf(t, "confidenceDrivenLuminanceEdgeStoppingRelaxation",
        s->confidence_driven_luminance_edge_stopping_relaxation);
    kvf(t, "confidenceDrivenNormalEdgeStoppingRelaxation",
        s->confidence_driven_normal_edge_stopping_relaxation);
    kvf(t, "luminanceEdgeStoppingRelaxation", s->luminance_edge_stopping_relaxation);
    kvf(t, "normalEdgeStoppingRelaxation", s->normal_edge_stopping_relaxation);
    kvf(t, "roughnessEdgeStoppingRelaxation", s->roughness_edge_stopping_relaxation);
    kvu(t, "checkerboardMode", s->checkerboard_mode);
    kvu(t, "hitDistanceReconstructionMode", s->hit_distance_reconstruction_mode);
    kvu(t, "enableAntiFirefly", (uint32_t)s->enable_anti_firefly);
    kvu(t, "enableRoughnessEdgeStopping", (uint32_t)s->enable_roughness_edge_stopping);
    kvf(t, "minMaterialForDiffuse", s->min_material_for_diffuse);
    kvf(t, "minMaterialForSpecular", s->min_material_for_specular);
    return nrdtpu_set_denoiser_settings(inst, identifier, t.c_str());
}

nrdtpu_result nrdtpu_set_sigma_settings(nrdtpu_instance* inst, uint32_t identifier,
                                        const nrdtpu_sigma_settings* s) {
    if (!s) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    std::string t;
    kvf(t, "planeDistanceSensitivity", s->plane_distance_sensitivity);
    kvu(t, "maxStabilizedFrameNum", s->max_stabilized_frame_num);
    nrdtpu_result r = nrdtpu_set_denoiser_settings(inst, identifier, t.c_str());
    if (r != NRDTPU_SUCCESS) return r;
    GilGuard gil;
    Ref settings(PyObject_GetAttrString(inst->engine, "_settings"));
    Ref key(PyLong_FromUnsignedLong(identifier));
    PyObject* cur = PyDict_GetItem(settings.p, key.p); /* borrowed */
    Ref tup(Py_BuildValue("(fff)", s->light_direction[0], s->light_direction[1],
                          s->light_direction[2]));
    if (!cur || !tup ||
        PyObject_SetAttrString(cur, "lightDirection", tup.p) != 0) {
        fetch_python_error();
        return NRDTPU_FAILURE;
    }
    return NRDTPU_SUCCESS;
}

nrdtpu_result nrdtpu_set_reference_settings(nrdtpu_instance* inst, uint32_t identifier,
                                            const nrdtpu_reference_settings* s) {
    if (!s) {
        set_error("invalid arguments");
        return NRDTPU_INVALID_ARGUMENT;
    }
    std::string t;
    kvu(t, "maxAccumulatedFrameNum", s->max_accumulated_frame_num);
    return nrdtpu_set_denoiser_settings(inst, identifier, t.c_str());
}

} /* extern "C" */
