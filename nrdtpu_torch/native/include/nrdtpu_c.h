/*
 * nrdtpu C ABI of the PyTorch port (nrdtpu_torch) - native entry points for the denoising
 * engine on an NVIDIA card.
 *
 * The same enums, structs and functions as the JAX package's header (native/include/
 * nrdtpu_c.h), which mirrors the role of NRD's public C ABI (Include/NRD.h:51-66:
 * CreateInstance / GetInstanceDesc / SetCommonSettings / SetDenoiserSettings /
 * GetComputeDispatches / DestroyInstance) re-shaped for an engine that executes, rather than
 * describes, the work: Denoise() runs the frame and fills the caller's output planes. One
 * entry point more, nrdtpu_create_instance_device, chooses the device as
 * nrdtpu_torch.engine.Engine(device=) does: "cuda" (what nrdtpu_create_instance means) or
 * "cpu". Where CUDA is missing, a "cuda" instance fails (NRDTPU_FAILURE, the engine's message
 * in nrdtpu_get_last_error); it never carries on on the CPU.
 *
 * All images are row-major float32 planes of resource_height x resource_width x channels,
 * pixel (x, y) at [y * width + x], on the host. Matrices are column-major 16-float arrays,
 * vector-is-a-column (same contract as NRDSettings.h:90-114).
 */

#ifndef NRDTPU_C_H
#define NRDTPU_C_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NRDTPU_VERSION_MAJOR 0
#define NRDTPU_VERSION_MINOR 1

typedef struct nrdtpu_instance nrdtpu_instance;

typedef enum nrdtpu_result {
    NRDTPU_SUCCESS = 0,
    NRDTPU_FAILURE = 1,
    NRDTPU_INVALID_ARGUMENT = 2,
    NRDTPU_UNSUPPORTED = 3,
} nrdtpu_result;

/* Matches nrdtpu_torch.settings.Denoiser (== reference Denoiser enum order). */
typedef enum nrdtpu_denoiser {
    NRDTPU_REBLUR_DIFFUSE = 0,
    NRDTPU_REBLUR_DIFFUSE_OCCLUSION = 1,
    NRDTPU_REBLUR_DIFFUSE_SH = 2,
    NRDTPU_REBLUR_SPECULAR = 3,
    NRDTPU_REBLUR_SPECULAR_OCCLUSION = 4,
    NRDTPU_REBLUR_SPECULAR_SH = 5,
    NRDTPU_REBLUR_DIFFUSE_SPECULAR = 6,
    NRDTPU_REBLUR_DIFFUSE_SPECULAR_OCCLUSION = 7,
    NRDTPU_REBLUR_DIFFUSE_SPECULAR_SH = 8,
    NRDTPU_REBLUR_DIFFUSE_DIRECTIONAL_OCCLUSION = 9,
    NRDTPU_RELAX_DIFFUSE = 10,
    NRDTPU_RELAX_DIFFUSE_SH = 11,
    NRDTPU_RELAX_SPECULAR = 12,
    NRDTPU_RELAX_SPECULAR_SH = 13,
    NRDTPU_RELAX_DIFFUSE_SPECULAR = 14,
    NRDTPU_RELAX_DIFFUSE_SPECULAR_SH = 15,
    NRDTPU_SIGMA_SHADOW = 16,
    NRDTPU_SIGMA_SHADOW_TRANSLUCENCY = 17,
    NRDTPU_REFERENCE = 18,
} nrdtpu_denoiser;

/* Matches nrdtpu_torch.settings.ResourceType (== reference ResourceType enum order). */
typedef enum nrdtpu_resource {
    NRDTPU_IN_MV = 0,
    NRDTPU_IN_NORMAL_ROUGHNESS = 1,
    NRDTPU_IN_VIEWZ = 2,
    NRDTPU_IN_DIFF_CONFIDENCE = 3,
    NRDTPU_IN_SPEC_CONFIDENCE = 4,
    NRDTPU_IN_DISOCCLUSION_THRESHOLD_MIX = 5,
    NRDTPU_IN_BASECOLOR_METALNESS = 6,
    NRDTPU_IN_DIFF_RADIANCE_HITDIST = 7,
    NRDTPU_IN_SPEC_RADIANCE_HITDIST = 8,
    NRDTPU_IN_DIFF_HITDIST = 9,
    NRDTPU_IN_SPEC_HITDIST = 10,
    NRDTPU_IN_DIFF_DIRECTION_HITDIST = 11,
    NRDTPU_IN_DIFF_SH0 = 12,
    NRDTPU_IN_DIFF_SH1 = 13,
    NRDTPU_IN_SPEC_SH0 = 14,
    NRDTPU_IN_SPEC_SH1 = 15,
    NRDTPU_IN_PENUMBRA = 16,
    NRDTPU_IN_TRANSLUCENCY = 17,
    NRDTPU_IN_SIGNAL = 18,
    NRDTPU_OUT_DIFF_RADIANCE_HITDIST = 19,
    NRDTPU_OUT_SPEC_RADIANCE_HITDIST = 20,
    NRDTPU_OUT_DIFF_SH0 = 21,
    NRDTPU_OUT_DIFF_SH1 = 22,
    NRDTPU_OUT_SPEC_SH0 = 23,
    NRDTPU_OUT_SPEC_SH1 = 24,
    NRDTPU_OUT_DIFF_HITDIST = 25,
    NRDTPU_OUT_SPEC_HITDIST = 26,
    NRDTPU_OUT_DIFF_DIRECTION_HITDIST = 27,
    NRDTPU_OUT_SHADOW_TRANSLUCENCY = 28,
    NRDTPU_OUT_SIGNAL = 29,
    NRDTPU_OUT_VALIDATION = 30,
    NRDTPU_RESOURCE_MAX_NUM = 31,
} nrdtpu_resource;

/* Flattened CommonSettings (NRDSettings.h:88-195 contract). */
typedef struct nrdtpu_common_settings {
    float view_to_clip_matrix[16];
    float view_to_clip_matrix_prev[16];
    float world_to_view_matrix[16];
    float world_to_view_matrix_prev[16];
    float world_prev_to_world_matrix[16];
    float motion_vector_scale[3];
    float camera_jitter[2];
    float camera_jitter_prev[2];
    uint16_t resource_size[2];
    uint16_t resource_size_prev[2];
    uint16_t rect_size[2];
    uint16_t rect_size_prev[2];
    float view_z_scale;
    float time_delta_between_frames;
    float denoising_range;
    float disocclusion_threshold;
    float disocclusion_threshold_alternate;
    float camera_attached_reflection_material_id;
    float strand_material_id;
    float strand_thickness;
    float split_screen;
    float debug;
    uint32_t rect_origin[2];
    uint32_t frame_index;
    uint8_t accumulation_mode; /* 0 CONTINUE, 1 RESTART, 2 CLEAR_AND_RESTART */
    uint8_t is_motion_vector_in_world_space;
    uint8_t is_history_confidence_available;
    uint8_t is_disocclusion_threshold_mix_available;
    uint8_t is_base_color_metalness_available;
    uint8_t enable_validation;
} nrdtpu_common_settings;

typedef struct nrdtpu_denoiser_desc {
    uint32_t identifier;
    nrdtpu_denoiser denoiser;
} nrdtpu_denoiser_desc;

/* One user-pool slot: caller-owned float32 plane. channels in {1, 2, 3, 4}.
 * For inputs, data is read at Denoise(); for outputs, data is written. */
typedef struct nrdtpu_resource_slot {
    nrdtpu_resource type;
    float* data;
    uint32_t channels;
} nrdtpu_resource_slot;

/* ---------------------------------------------------------------------------
 * Typed per-denoiser settings (NRDSettings.h:201-461; field order follows the
 * python dataclasses in nrdtpu_torch/settings.py, which mirror the reference structs).
 * Marshalled onto the python settings objects by the typed setters below; the
 * text API (nrdtpu_set_denoiser_settings) remains for forward compatibility.
 * Enum-typed fields carry the reference enum values (NRDSettings.h:68-86):
 * checkerboard_mode 0 OFF / 1 BLACK / 2 WHITE; hit_distance_reconstruction_mode
 * 0 OFF / 1 AREA_3X3 / 2 AREA_5X5. */

typedef struct nrdtpu_hit_distance_parameters {
    float a, b, c, d; /* NRDSettings.h:206-219 */
} nrdtpu_hit_distance_parameters;

typedef struct nrdtpu_reblur_settings {
    nrdtpu_hit_distance_parameters hit_distance_parameters;
    float antilag_luminance_sigma_scale;
    float antilag_luminance_sensitivity;
    uint32_t max_accumulated_frame_num;
    uint32_t max_fast_accumulated_frame_num;
    uint32_t max_stabilized_frame_num;
    uint32_t max_stabilized_frame_num_for_hit_distance;
    uint32_t history_fix_frame_num;
    uint32_t history_fix_base_pixel_stride;
    float diffuse_prepass_blur_radius;
    float specular_prepass_blur_radius;
    float min_hit_distance_weight;
    float min_blur_radius;
    float max_blur_radius;
    float lobe_angle_fraction;
    float roughness_fraction;
    float responsive_accumulation_roughness_threshold;
    float plane_distance_sensitivity;
    float specular_probability_thresholds_for_mv_modification[2];
    float firefly_suppressor_min_relative_scale;
    uint32_t checkerboard_mode;
    uint32_t hit_distance_reconstruction_mode;
    uint8_t enable_anti_firefly;
    uint8_t enable_performance_mode;
    float min_material_for_diffuse;
    float min_material_for_specular;
    uint8_t use_prepass_only_for_specular_motion_estimation;
} nrdtpu_reblur_settings;

typedef struct nrdtpu_relax_settings {
    float antilag_acceleration_amount;
    float antilag_spatial_sigma_scale;
    float antilag_temporal_sigma_scale;
    float antilag_reset_amount;
    uint32_t diffuse_max_accumulated_frame_num;
    uint32_t specular_max_accumulated_frame_num;
    uint32_t diffuse_max_fast_accumulated_frame_num;
    uint32_t specular_max_fast_accumulated_frame_num;
    uint32_t history_fix_frame_num;
    uint32_t history_fix_base_pixel_stride;
    float history_fix_edge_stopping_normal_power;
    uint32_t spatial_variance_estimation_history_threshold;
    float diffuse_prepass_blur_radius;
    float specular_prepass_blur_radius;
    float min_hit_distance_weight;
    float diffuse_phi_luminance;
    float specular_phi_luminance;
    float lobe_angle_fraction;
    float roughness_fraction;
    float specular_variance_boost;
    float specular_lobe_angle_slack;
    float history_clamping_color_box_sigma_scale;
    uint32_t atrous_iteration_num;
    float diffuse_min_luminance_weight;
    float specular_min_luminance_weight;
    float depth_threshold;
    float confidence_driven_relaxation_multiplier;
    float confidence_driven_luminance_edge_stopping_relaxation;
    float confidence_driven_normal_edge_stopping_relaxation;
    float luminance_edge_stopping_relaxation;
    float normal_edge_stopping_relaxation;
    float roughness_edge_stopping_relaxation;
    uint32_t checkerboard_mode;
    uint32_t hit_distance_reconstruction_mode;
    uint8_t enable_anti_firefly;
    uint8_t enable_roughness_edge_stopping;
    float min_material_for_diffuse;
    float min_material_for_specular;
} nrdtpu_relax_settings;

typedef struct nrdtpu_sigma_settings {
    float light_direction[3];
    float plane_distance_sensitivity;
    uint32_t max_stabilized_frame_num;
} nrdtpu_sigma_settings;

typedef struct nrdtpu_reference_settings {
    uint32_t max_accumulated_frame_num;
} nrdtpu_reference_settings;

/* Fill a settings struct with the reference defaults (NRDSettings.h defaults,
 * same values as the python dataclasses). */
void nrdtpu_get_default_reblur_settings(nrdtpu_reblur_settings* out);
void nrdtpu_get_default_relax_settings(nrdtpu_relax_settings* out);
void nrdtpu_get_default_sigma_settings(nrdtpu_sigma_settings* out);
void nrdtpu_get_default_reference_settings(nrdtpu_reference_settings* out);

/* Typed SetDenoiserSettings (Wrapper.cpp:207-233 analogue). The settings type
 * must match the denoiser family behind `identifier`. */
nrdtpu_result nrdtpu_set_reblur_settings(nrdtpu_instance* instance, uint32_t identifier,
                                         const nrdtpu_reblur_settings* settings);
nrdtpu_result nrdtpu_set_relax_settings(nrdtpu_instance* instance, uint32_t identifier,
                                        const nrdtpu_relax_settings* settings);
nrdtpu_result nrdtpu_set_sigma_settings(nrdtpu_instance* instance, uint32_t identifier,
                                        const nrdtpu_sigma_settings* settings);
nrdtpu_result nrdtpu_set_reference_settings(nrdtpu_instance* instance, uint32_t identifier,
                                            const nrdtpu_reference_settings* settings);

/* Library info (Wrapper.cpp:46-57 LibraryDesc analogue; the SPIRV binding
 * offsets have no TPU meaning and are omitted). */
typedef struct nrdtpu_library_desc {
    uint32_t version_major;
    uint32_t version_minor;
    const nrdtpu_denoiser* supported_denoisers;
    uint32_t supported_denoiser_num;
    uint32_t normal_encoding;    /* default build encoding, NRDDescs.h:340-362 */
    uint32_t roughness_encoding; /* NRDDescs.h:364-370 */
} nrdtpu_library_desc;

const nrdtpu_library_desc* nrdtpu_get_library_desc(void);

/* Name tables (Wrapper.cpp:58-123 GetDenoiserString / GetResourceTypeString). */
const char* nrdtpu_get_denoiser_string(nrdtpu_denoiser denoiser);
const char* nrdtpu_get_resource_type_string(nrdtpu_resource resource);

/* Library info (GetLibraryDesc analogue). */
const char* nrdtpu_get_version_string(void);

/* CreateInstance analogue. normal_encoding / roughness_encoding match the
 * NormalEncoding / RoughnessEncoding enums (NRDDescs.h:340-370). */
nrdtpu_result nrdtpu_create_instance(const nrdtpu_denoiser_desc* denoisers,
                                     uint32_t denoiser_num,
                                     uint16_t resource_w, uint16_t resource_h,
                                     uint32_t normal_encoding,
                                     uint32_t roughness_encoding,
                                     nrdtpu_instance** out_instance);

/* CreateInstance on a chosen device: "cuda" (the default of nrdtpu_create_instance),
 * "cuda:N" or "cpu" (the plain PyTorch versions of the kernels). */
nrdtpu_result nrdtpu_create_instance_device(const nrdtpu_denoiser_desc* denoisers,
                                            uint32_t denoiser_num,
                                            uint16_t resource_w, uint16_t resource_h,
                                            uint32_t normal_encoding,
                                            uint32_t roughness_encoding,
                                            const char* device,
                                            nrdtpu_instance** out_instance);

nrdtpu_result nrdtpu_set_common_settings(nrdtpu_instance* instance,
                                         const nrdtpu_common_settings* settings);

/* SetDenoiserSettings analogue: settings passed as "key=value;..." text to stay
 * ABI-stable across settings-struct evolution (numeric fields of the python dataclasses). */
nrdtpu_result nrdtpu_set_denoiser_settings(nrdtpu_instance* instance, uint32_t identifier,
                                           const char* settings_kv);

/* Run the denoisers for this frame. Inputs and outputs are given as resource slots. */
nrdtpu_result nrdtpu_denoise(nrdtpu_instance* instance,
                             const uint32_t* identifiers, uint32_t identifier_num,
                             const nrdtpu_resource_slot* slots, uint32_t slot_num);

nrdtpu_result nrdtpu_destroy_instance(nrdtpu_instance* instance);

/* Last error message for a failed call (thread-local). */
const char* nrdtpu_get_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* NRDTPU_C_H */
